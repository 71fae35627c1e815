// Per-cell CLAHE core: tile histograms, Zuiderveld clip + redistribute,
// integer CDF maps and the exact-integer 4-corner blend.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/clahe_kernel.py,
//   clahe_core_pallas -> _kernel, _clip_hist_vmem, _row_cumsum (one
//   program per cell; one-hot MXU histograms and cumsums, a vectorized
//   while loop over the 256-tile x 256-bin table in VMEM).
//
// What bounds it on the H100: shared memory and latency, not FLOPs.  A
// cell's table is up to 16 x 16 tiles x 256 bins; in int32 that is 256 KB,
// more than the 227 KB a block may hold.  The histogram pass is bound by
// shared-memory atomics, the clip loop by its few data-dependent rounds.
//
// Design: one block per cell.  Counts are 16-bit, two to a 32-bit shared
// word (a tile holds at most kh*kw <= 24*24 = 576 pixels at crop capacity
// 192, and the Python wrapper bounds kh*kw <= 1024), so the table is 128 KB
// at ns_cap 16 and 72 KB at ns_cap 12.  The histogram pass adds 1 << 16 or
// 1 to the word with a shared atomic.  Then one warp owns one tile at a
// time: each lane holds 8 consecutive bins in registers, the clip loop
// takes its rank with a warp prefix count, and the CDF with a warp prefix
// sum; the maps (<= 16383) are written back into the same 16-bit slots.
// The blend reads the 4 corner maps per pixel and floors S by kh*kw in
// int32.  Every operand is a non-negative integer, so C++ truncating `/`
// and `%` agree with the floor semantics of the reference; the reflect
// fold and tile arithmetic are done by the wrapper.
//
// Inputs per cell (C cells, row-major): vbins, vtiles (C, Pv) int32 — bin
// and tile id of each virtual-grid pixel, tile -1 where the pixel is not
// in any tile; pbins (C, P) int32; ptiles, pw (C, P, 4) int32 — corner
// tile ids and integer weight numerators; clim, area (C,) int32.  Output
// (C, P) float32 blended grays before the min-max rescale.

#include <cuda_runtime.h>

namespace {

constexpr int NBINS = 256;
constexpr int NR_OF_GRAY = 1 << 14;
constexpr int WORDS_PER_TILE = NBINS / 2;
constexpr int THREADS = 512;
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
// (lane owns bins 8*lane .. 8*lane+7): ops/clahe._clip_histogram.
__device__ void clip_histogram(int h[8], int clim, int lane) {
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

__global__ void __launch_bounds__(THREADS)
clahe_core_kernel(const int* __restrict__ vbins, const int* __restrict__ vtiles, int Pv,
                  const int* __restrict__ pbins, const int* __restrict__ ptiles,
                  const int* __restrict__ pw, int P, const int* __restrict__ clim_c,
                  const int* __restrict__ area_c, int n_tiles, float* __restrict__ out) {
  extern __shared__ unsigned int hist[];   // n_tiles * 128 words, 2 counts each
  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_words = n_tiles * WORDS_PER_TILE;
  for (int i = tid; i < n_words; i += blockDim.x) hist[i] = 0u;
  __syncthreads();

  // 1. histograms of the reflect-folded virtual grid
  const int* vb = vbins + (size_t)cell * Pv;
  const int* vt = vtiles + (size_t)cell * Pv;
  for (int p = tid; p < Pv; p += blockDim.x) {
    const int t = vt[p];
    if (t >= 0) {
      const int b = vb[p];
      atomicAdd(&hist[t * WORDS_PER_TILE + (b >> 1)], 1u << ((b & 1) * 16));
    }
  }
  __syncthreads();

  // 2. clip + redistribute, 3. integer CDF maps: one warp per tile
  const int clim = clim_c[cell];
  const int area = area_c[cell];
  const int lane = tid & 31;
  for (int t = tid >> 5; t < n_tiles; t += blockDim.x >> 5) {
    unsigned int* row = hist + t * WORDS_PER_TILE + 4 * lane;
    int h[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned w = row[q];
      h[2 * q] = (int)(w & 0xffffu);
      h[2 * q + 1] = (int)(w >> 16);
    }
    clip_histogram(h, clim, lane);
    int s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += h[i];
      h[i] = s;                              // lane-local inclusive cumsum
    }
    const int base = warp_exclusive_scan(s, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = min((h[i] + base) * (NR_OF_GRAY - 1) / area, NR_OF_GRAY - 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) row[q] = (unsigned)h[2 * q] | ((unsigned)h[2 * q + 1] << 16);
  }
  __syncthreads();

  // 4. exact-integer 4-corner blend, floored by kh*kw
  const int* pb = pbins + (size_t)cell * P;
  const int4* pt = reinterpret_cast<const int4*>(ptiles) + (size_t)cell * P;
  const int4* pwt = reinterpret_cast<const int4*>(pw) + (size_t)cell * P;
  float* o = out + (size_t)cell * P;
  for (int p = tid; p < P; p += blockDim.x) {
    const int b = pb[p];
    const int4 t4 = pt[p];
    const int4 w4 = pwt[p];
    const int sh = (b & 1) * 16;
    const int col = b >> 1;
    const int m0 = (hist[t4.x * WORDS_PER_TILE + col] >> sh) & 0xffff;
    const int m1 = (hist[t4.y * WORDS_PER_TILE + col] >> sh) & 0xffff;
    const int m2 = (hist[t4.z * WORDS_PER_TILE + col] >> sh) & 0xffff;
    const int m3 = (hist[t4.w * WORDS_PER_TILE + col] >> sh) & 0xffff;
    const int S = w4.x * m0 + w4.y * m1 + w4.z * m2 + w4.w * m3;
    o[p] = (float)(S / area);
  }
}

}  // namespace

extern "C" int cia_clahe_core(const void* vbins, const void* vtiles, int Pv,
                              const void* pbins, const void* ptiles, const void* pw, int P,
                              const void* clim, const void* area, int n_cells, int n_tiles,
                              void* out, void* stream) {
  if (n_cells <= 0) return (int)cudaGetLastError();
  const int smem = n_tiles * WORDS_PER_TILE * (int)sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      clahe_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  clahe_core_kernel<<<n_cells, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)vbins, (const int*)vtiles, Pv, (const int*)pbins, (const int*)ptiles,
      (const int*)pw, P, (const int*)clim, (const int*)area, n_tiles, (float*)out);
  return (int)cudaGetLastError();
}
