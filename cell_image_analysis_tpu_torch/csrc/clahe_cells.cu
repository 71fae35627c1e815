// CLAHE of one size bucket of cell crops, fused: the whole of
// ops/clahe.clahe_cells (skimage equalize_adapthist semantics) in one
// launch, bit-equal to its plain version.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/clahe_kernel.py,
//   clahe_core_pallas (one program per cell: one-hot MXU histograms and
//   cumsums, a vectorized clip loop over the tile x bin table in VMEM),
//   together with the per-pixel preparation and the min-max rescale that
//   XLA fused around it on the TPU (ops/clahe.py: _quantize14, the
//   reflect-folded virtual grid, the corner tiles and weights).
//
// What bounds it on the H100: device memory, at a few microseconds.  The
// least it must move is each cell's valid crop pixels read once and its
// (cap, cap) float32 output written once: ~18 MB, ~5.4 us at 3.35 TB/s,
// for ~800 cells at cap 64.  Everything between (14-bit levels, bins,
// tile histograms, CDF maps) stays in shared memory; the plain version
// writes ~44 bytes a pixel of prepared tensors to device memory and
// launches ~100 tensor operations for every chunk of cells.
//
// Design: blockIdx.x / bands is the cell; a cell's `bands` blocks form a
// thread-block cluster (the wrapper launches 4 while the cells are fewer
// than the SMs, else 2; any size up to 4 runs the same code).  Block r of
// the cluster owns a band of tile rows [r0, r1) and
//   1. reads its cell's index, height and width; reads the crop rows its
//      band needs in place from the (N, full_cap, full_cap) crop tensor
//      and reduces min, max and "every value an integer in [0, 2^24)";
//   2. meets the other blocks of the cluster (distributed shared memory)
//      to combine those partials, then quantizes its rows to the exact
//      14-bit levels (the integer path when the whole crop allows it,
//      else the float path, as _quantize14) and keeps their 256-level
//      bins in shared memory (one byte a pixel);
//   3. builds its tiles' histograms over the reflect-folded virtual grid
//      (16-bit counts, two to a 32-bit word: at most kh*kw <= 31*31 per
//      tile), clips and redistributes them (Zuiderveld, a warp per tile,
//      8 bins a lane) and writes the integer CDF maps back in place;
//   4. blends its output rows from the four corner maps, S // (kh*kw),
//      reading the row of maps above its band from the neighbouring
//      block's shared memory, and meets the cluster again for the cell's
//      min and max of the blend;
//   5. blends again and writes (v - lo) * (1 / (hi - lo)), 0 outside
//      [:h, :w], to the (C, cap, cap) output.
// A cell the kernel cannot take (an index outside [0, N), a side above
// cap, more tiles than ns_cap a side) comes out NaN: nothing is written
// out of bounds and the caller's check sees it.
//
// Exactness: the integer operands of every `/` and `%` are non-negative,
// so C++ truncation equals the floor of the plain version; the two float
// divisions are IEEE (__fdiv_rn), the rounding is rintf (half to even, as
// torch.round), and no float expression can contract into an FMA (every
// product goes through __fmul_rn, every difference through __fsub_rn).
// 2*k*16383 + D fits int32 (at most 2,147,385,345 for k, D <= 65535).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int NBINS = 256;
constexpr int NR_OF_GRAY = 1 << 14;
constexpr int BIN_DIV = 1 + NR_OF_GRAY / NBINS;  // 65
constexpr int WORDS_PER_TILE = NBINS / 2;
constexpr int THREADS = 256;
constexpr int MAX_BANDS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_exclusive_scan(int v, int lane) {
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += n;
  }
  return incl - v;
}

// Zuiderveld clip + redistribute of one 256-bin histogram held by a warp
// (lane owns bins 8*lane .. 8*lane+7): ops/clahe.clahe_core_plain.
__device__ __forceinline__ void clip_histogram(int h[8], int clim, int lane) {
  int ex = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (h[i] > clim) {
      ex += h[i] - clim;
      h[i] = clim;
    }
  }
  int n_excess = warp_sum(ex);
  const int bin_incr = n_excess / NBINS;
  const int upper = clim - bin_incr;
  int n_low = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (h[i] < upper) {
      ++n_low;
      h[i] += bin_incr;
    }
  }
  n_excess -= warp_sum(n_low) * bin_incr;
  int mid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (h[i] >= upper && h[i] < clim) {
      mid += h[i] - clim;
      h[i] = clim;
    }
  }
  n_excess += warp_sum(mid);

  int added = 1;
  while (n_excess > 0 && added > 0) {       // warp-uniform condition
    const int step = max(1, NBINS / max(n_excess, 1));
    bool el[8];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      el[i] = h[i] < clim && ((8 * lane + i) % step) == 0;
      cnt += el[i];
    }
    int rank = warp_exclusive_scan(cnt, lane);
    int n_add = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (el[i]) {
        ++rank;                              // inclusive prefix count
        if (rank <= n_excess) {
          ++h[i];
          ++n_add;
        }
      }
    }
    added = warp_sum(n_add);
    n_excess -= added;
  }
}

// numpy.pad mode='reflect' fold for 0 <= i < 2n - 1 (ops/clahe._reflect)
__device__ __forceinline__ int reflect(int i, int n) {
  const int over = i - (n - 1);
  if (over > 0) i = n - 1 - over;
  return min(max(i, 0), max(n - 1, 0));
}

// The rows of one band: tile rows [r0, r1), output rows [y0, y1), and the
// crop rows [yb0, yb1) whose bins it keeps (its output rows, the rows its
// tiles cover, and for the last band the rows the reflect fold reads).
struct Band {
  int r0, r1, y0, y1, yb0, yb1;
};

__device__ Band band_of(int rank, int bands, int h, int kh, int ns_h) {
  const int per = (ns_h + bands - 1) / bands;
  Band b;
  b.r0 = min(rank * per, ns_h);
  b.r1 = min(b.r0 + per, ns_h);
  if (b.r0 >= b.r1) {
    b.y0 = b.y1 = b.yb0 = b.yb1 = 0;
    return b;
  }
  const bool last = b.r1 == ns_h;
  b.y0 = b.r0 == 0 ? 0 : b.r0 * kh - kh / 2;
  b.y1 = last ? h : b.r1 * kh - kh / 2;
  b.yb0 = last ? min(b.y0, max(0, 2 * h - 1 - ns_h * kh)) : b.y0;
  b.yb1 = min(b.r1 * kh, h);
  return b;
}

// the exact 14-bit level of one valid pixel (ops/clahe._quantize14)
__device__ __forceinline__ int quantize14(float v, float lo, float hi, float scale, int D,
                                          bool exact) {
  if (!(hi > lo)) return 0;
  if (exact) {
    const int k = (int)fminf(fmaxf(__fsub_rn(v, lo), 0.f), 65535.f);
    const int t = 2 * k * (NR_OF_GRAY - 1) + D;
    const int q = t / (2 * D);
    const int r = t - q * (2 * D);
    return q - ((r == 0) & (q & 1));
  }
  const float f = rintf(__fmul_rn(__fsub_rn(v, lo), scale));
  return (int)fminf(fmaxf(f, -2147483648.f), 2147483520.f);
}

__device__ __forceinline__ bool is_small_int(float v) {
  return v == rintf(v) && v >= 0.f && v < 16777216.f;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();                           // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int i = 1; i < nwarps; ++i) r = op(r, scratch[i]);
  return r;
}

struct MinF { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct MaxF { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinI { __device__ int operator()(int a, int b) const { return min(a, b); } };
struct MaxI { __device__ int operator()(int a, int b) const { return max(a, b); } };
struct AndI { __device__ int operator()(int a, int b) const { return a & b; } };

__global__ void __launch_bounds__(THREADS)
clahe_cells_kernel(const float* __restrict__ crops, int full_cap, int n_crops,
                   const int* __restrict__ ids, const int* __restrict__ heights,
                   const int* __restrict__ widths, int cap, int ns_cap, float clip_limit,
                   int grid, int bands, int rows_alloc, int bin_rows_alloc,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kmax = max(1, cap / grid);
  const int tile_row_words = ns_cap * WORDS_PER_TILE;
  unsigned* table = reinterpret_cast<unsigned*>(smem);                  // rows_alloc tile rows
  unsigned char* bins = smem + (size_t)rows_alloc * tile_row_words * 4;  // bin_rows_alloc x cap
  int* vcol = reinterpret_cast<int*>(bins + ((bin_rows_alloc * cap + 15) & ~15));
  int* ocol = vcol + cap + kmax;             // per output column
  float* fscratch = reinterpret_cast<float*>(ocol + cap);   // 32 words
  int* iscratch = reinterpret_cast<int*>(fscratch + 32);    // 32 words
  float* xch_f = reinterpret_cast<float*>(iscratch + 32);   // lo, hi: read by the cluster
  int* xch_i = reinterpret_cast<int*>(xch_f + 2);           // int_ok, min, max

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / bands;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  float* o = out + (size_t)c * cap * cap;

  // the cell, and whether the kernel can take it (the same answer in every
  // block of the cluster, so all of them leave here or none does)
  const int id = ids[c];
  const bool id_ok = id >= 0 && id < n_crops;
  const int h = id_ok ? heights[id] : -1;
  const int w = id_ok ? widths[id] : -1;
  bool ok = id_ok && h >= 0 && w >= 0 && h <= cap && w <= cap;
  const int kh = max(h / grid, 1), kw = max(w / grid, 1);
  const int ns_h = ok ? (h + kh - 1) / kh : 0;
  const int ns_w = ok ? (w + kw - 1) / kw : 0;
  ok = ok && ns_h <= ns_cap && ns_w <= ns_cap;
  for (int q = 0; ok && q < bands; ++q) {
    const Band bq = band_of(q, bands, h, kh, ns_h);
    ok = bq.r1 - bq.r0 <= rows_alloc && bq.yb1 - bq.yb0 <= bin_rows_alloc;
  }
  if (!ok || h == 0 || w == 0) {
    const float fill = ok ? 0.f : __int_as_float(0x7fc00000);
    for (int i = rank * blockDim.x + tid; i < cap * cap; i += bands * blockDim.x) o[i] = fill;
    return;
  }
  const Band b = band_of(rank, bands, h, kh, ns_h);
  const float* crop = crops + (size_t)id * full_cap * full_cap;

  // column tables: virtual column -> (reflected column, tile column);
  // output column -> (corner tile columns, offset in the tile)
  for (int xv = tid; xv < ns_w * kw; xv += blockDim.x) vcol[xv] = reflect(xv, w) | ((xv / kw) << 16);
  for (int x = tid; x < w; x += blockDim.x) {
    const int xp = x + kw / 2, ptx = xp / kw;
    const int mx0 = min(max(ptx - 1, 0), ns_w - 1), mx1 = min(ptx, ns_w - 1);
    ocol[x] = mx0 | (mx1 << 8) | ((xp - ptx * kw) << 16);
  }
  for (int i = tid; i < (b.r1 - b.r0) * tile_row_words; i += blockDim.x) table[i] = 0u;

  // 1. min, max and integrality of the band's crop rows
  float lo = FLT_MAX, hi = -FLT_MAX;
  int int_ok = 1;
  for (int y = b.yb0 + warp; y < b.yb1; y += nwarps) {
    const float* row = crop + (size_t)y * full_cap;
    for (int x = lane; x < w; x += 32) {
      const float v = row[x];
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
      int_ok &= is_small_int(v);
    }
  }
  lo = block_reduce(lo, MinF(), fscratch);
  hi = block_reduce(hi, MaxF(), fscratch);
  int_ok = block_reduce(int_ok, AndI(), iscratch);
  if (tid == 0) {
    xch_f[0] = lo;
    xch_f[1] = hi;
    xch_i[0] = int_ok;
  }
  cluster.sync();
  for (int q = 0; q < bands; ++q) {
    const float* f = cluster.map_shared_rank(xch_f, q);
    lo = fminf(lo, f[0]);
    hi = fmaxf(hi, f[1]);
    int_ok &= *cluster.map_shared_rank(xch_i, q);
  }

  // 2. 14-bit levels -> bins of the band's crop rows, in shared memory
  const float range = __fsub_rn(hi, lo);
  const bool exact = int_ok && range <= 65535.f && hi > lo;
  const float scale = hi > lo ? __fdiv_rn((float)(NR_OF_GRAY - 1), range) : 0.f;
  const int D = max((int)fminf(fmaxf(range, 0.f), 65535.f), 1);
  for (int y = b.yb0 + warp; y < b.yb1; y += nwarps) {
    const float* row = crop + (size_t)y * full_cap;
    unsigned char* brow = bins + (y - b.yb0) * cap;
    for (int x = lane; x < w; x += 32) {
      const int q14 = quantize14(row[x], lo, hi, scale, D, exact);
      brow[x] = (unsigned char)min(max(q14 / BIN_DIV, 0), NBINS - 1);
    }
  }
  __syncthreads();

  // 3. histograms of the band's tiles over the reflect-folded virtual grid
  for (int yv = b.r0 * kh + warp; yv < b.r1 * kh; yv += nwarps) {
    const unsigned char* brow = bins + (reflect(yv, h) - b.yb0) * cap;
    unsigned* trow = table + (yv / kh - b.r0) * tile_row_words;
    for (int xv = lane; xv < ns_w * kw; xv += 32) {
      const int info = vcol[xv];
      const int bin = brow[info & 0xffff];
      atomicAdd(&trow[(info >> 16) * WORDS_PER_TILE + (bin >> 1)], 1u << ((bin & 1) * 16));
    }
  }
  __syncthreads();

  //    clip + redistribute, integer CDF maps: a warp per tile
  const int area = kh * kw;
  const int clim = max((int)__fmul_rn(clip_limit, (float)area), 1);
  for (int t = warp; t < (b.r1 - b.r0) * ns_w; t += nwarps) {
    const int lt = t / ns_w;
    unsigned* row = table + lt * tile_row_words + (t - lt * ns_w) * WORDS_PER_TILE + 4 * lane;
    int hv[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned u = row[q];
      hv[2 * q] = (int)(u & 0xffffu);
      hv[2 * q + 1] = (int)(u >> 16);
    }
    clip_histogram(hv, clim, lane);
    int s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += hv[i];
      hv[i] = s;                             // lane-local inclusive cumsum
    }
    const int base = warp_exclusive_scan(s, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      hv[i] = min((hv[i] + base) * (NR_OF_GRAY - 1) / area, NR_OF_GRAY - 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) row[q] = (unsigned)hv[2 * q] | ((unsigned)hv[2 * q + 1] << 16);
  }
  cluster.sync();                            // every band's maps are ready

  // 4-5. the 4-corner blend S // (kh*kw), twice: for the cell's min and
  // max, then for the rescaled output
  const int per = (ns_h + bands - 1) / bands;
  auto tile_row = [&](int my) -> const unsigned* {
    const int owner = my / per;
    return cluster.map_shared_rank(table, owner) + (my - owner * per) * tile_row_words;
  };
  int vmin = INT_MAX, vmax = INT_MIN;
  float lo2 = 0.f, scale2 = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int y = b.y0 + warp; y < b.y1; y += nwarps) {
      const int yp = y + kh / 2, pty = yp / kh, ay = yp - pty * kh;
      const unsigned* t0 = tile_row(min(max(pty - 1, 0), ns_h - 1));
      const unsigned* t1 = tile_row(min(pty, ns_h - 1));
      const int ny0 = kh - ay, ny1 = ay;
      const unsigned char* brow = bins + (y - b.yb0) * cap;
      float* orow = o + (size_t)y * cap;
      for (int x = lane; x < cap; x += 32) {
        if (x >= w) {
          if (pass) orow[x] = 0.f;
          continue;
        }
        const int bin = brow[x], info = ocol[x];
        const int col = bin >> 1, sh = (bin & 1) * 16;
        const int c0 = (info & 0xff) * WORDS_PER_TILE + col;
        const int c1 = ((info >> 8) & 0xff) * WORDS_PER_TILE + col;
        const int ax = info >> 16, nx0 = kw - ax, nx1 = ax;
        const int m00 = (t0[c0] >> sh) & 0xffff, m01 = (t0[c1] >> sh) & 0xffff;
        const int m10 = (t1[c0] >> sh) & 0xffff, m11 = (t1[c1] >> sh) & 0xffff;
        const int v = (ny0 * (nx0 * m00 + nx1 * m01) + ny1 * (nx0 * m10 + nx1 * m11)) / area;
        if (pass) {
          orow[x] = __fmul_rn(__fsub_rn((float)v, lo2), scale2);
        } else {
          vmin = min(vmin, v);
          vmax = max(vmax, v);
        }
      }
    }
    if (pass) break;
    vmin = block_reduce(vmin, MinI(), iscratch);
    vmax = block_reduce(vmax, MaxI(), iscratch);
    if (tid == 0) {
      xch_i[1] = vmin;
      xch_i[2] = vmax;
    }
    cluster.sync();
    for (int q = 0; q < bands; ++q) {
      const int* p = cluster.map_shared_rank(xch_i, q);
      vmin = min(vmin, p[1]);
      vmax = max(vmax, p[2]);
    }
    lo2 = (float)vmin;
    const float hi2 = (float)vmax;
    scale2 = hi2 > lo2 ? __fdiv_rn(1.f, __fsub_rn(hi2, lo2)) : 0.f;
  }
  for (int y = h + rank * nwarps + warp; y < cap; y += bands * nwarps)
    for (int x = lane; x < cap; x += 32) o[(size_t)y * cap + x] = 0.f;
  cluster.sync();                            // no block leaves while its maps are read
}

// The shared-memory layout of a block: rows_alloc tile rows of maps,
// bin_rows_alloc crop rows of bins, the column tables and the scratch.
struct SmemPlan {
  int rows_alloc, bin_rows_alloc, bytes;
};

SmemPlan smem_plan(int cap, int ns_cap, int grid, int bands) {
  const int kmax = cap / grid > 1 ? cap / grid : 1;
  SmemPlan p;
  p.rows_alloc = (ns_cap + bands - 1) / bands;
  p.bin_rows_alloc = (cap + bands - 1) / bands + kmax + kmax / 2;
  if (p.bin_rows_alloc > cap) p.bin_rows_alloc = cap;
  p.bytes = p.rows_alloc * ns_cap * WORDS_PER_TILE * 4 + ((p.bin_rows_alloc * cap + 15) & ~15) +
            (cap + kmax + cap) * 4 + (32 + 32 + 2 + 3) * 4;
  return p;
}

}  // namespace

extern "C" int cia_clahe_cells(const void* crops, int full_cap, int n_crops, const void* ids,
                               int n_cells, const void* heights, const void* widths, int cap,
                               int ns_cap, float clip_limit, int grid, int bands, void* out,
                               void* stream) {
  if (n_cells <= 0) return (int)cudaGetLastError();
  if (bands < 1 || bands > MAX_BANDS) return (int)cudaErrorInvalidValue;
  const SmemPlan plan = smem_plan(cap, ns_cap, grid, bands);
  cudaError_t err = cudaFuncSetAttribute(
      clahe_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_cells * bands));
  cfg.blockDim = dim3((unsigned)THREADS);
  cfg.dynamicSmemBytes = (size_t)plan.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, clahe_cells_kernel, (const float*)crops, full_cap, n_crops,
                           (const int*)ids, (const int*)heights, (const int*)widths, cap, ns_cap,
                           clip_limit, grid, bands, plan.rows_alloc, plan.bin_rows_alloc,
                           (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
