// Connected components of boolean masks, compacted: `label_components`.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/cc_kernel.py:80,
//   cc_min_labels_pallas (the whole label image resident in VMEM, min-label
//   sweeps until a change flag clears), and the compaction of the raw
//   labels to 1..K that cell_image_analysis_tpu/ops/cc.py:230-237 runs after
//   it in XLA.
//
// Contract: mask (B, H, W) bool (one byte a pixel, 0 or 1, read in place),
// connectivity 1 (4-neighbourhood) or 2 (8-neighbourhood) -> out (B, H, W)
// int32, components numbered 1..count[b] in raster order of their first
// pixel (scipy.ndimage.label's numbering), 0 on the background, and count
// (B,) int32.  Scratch: parent (B, H, W) int32, touched only at tile edges
// and local roots; bits (B, H, ceil(W/64)) uint64; offsets (B, H,
// ceil(W/64)) int32; rows (B, H) int32.  None of them needs initialising.
//
// What bounds it on the H100: bytes.  The mask must be read (1 B a pixel)
// and the labels written (4 B a pixel): 83.9 MB for 16 x 1024^2, 25 us at
// 3.35 TB/s.  Union-find over every pixel in device memory (the first port
// of this kernel) writes and re-reads a 64 MB parent array and chases
// roots through L2 with atomics; the compaction after it in eager torch
// moved ~1.3 GB more.
//
// Design: block-based union-find (Playne & Hawick, IEEE TPDS 2018;
// Allegretti, Bolelli & Grana, IEEE TPDS 2020) in 32 x 64 pixel tiles, five
// launches, every one over the whole batch.  A tile is one warp's (four a
// block), and each lane owns one row of it as a 64-bit word: runs, their
// overlaps with the row above and the diagonal contacts are bit operations,
// and the union-find nodes are the runs (node r * 32 + k for the k-th run of
// row r: raster order, at most 32 runs a row), so a lane does work for its
// row's runs and contacts, not for its 64 pixels, and a tile's shared
// memory is 5.4 KB.  The two tile passes run as many blocks as fit on the
// card at once; each warp walks the batch's tiles and loads the next
// tile's mask before it works on the current one.
//   1. cc_tile_local: a warp loads its tile's mask (16-byte loads) into row
//      words and unites, in shared memory, each run with the runs of the
//      row above that it touches, once a contact segment (atomicMin, the
//      larger root under the smaller), then flattens.  A tile's raster order
//      is the frame's raster order restricted to it, so each local root is
//      the run that holds its local component's smallest frame index.  It
//      writes parent[g] = g at its local roots and parent[p] = root(p) at
//      the foreground pixels of its four edges, and a bit a local root into
//      `bits`, one word a (row, tile column) segment.
//   2. cc_tile_merge: one thread a pixel on a tile boundary unites, in
//      device memory, the roots of each pair of touching foreground pixels
//      that lie in different tiles (plus the diagonal pairs at connectivity
//      2), skipping a pair that a pair beside it in the same two tiles
//      implies (an all-true edge makes one union, not 64).  Roots are read
//      with __ldcg and linked with atomicMin, always the larger under the
//      smaller, so whatever order the threads ran in, each component's root
//      is its smallest frame index.
//   3. cc_tile_roots: a warp a row, a lane a segment, keeps the bits of the
//      local roots that are still roots (parent[g] == g): the global roots;
//      writes each segment's count of them before it in its row
//      (`offsets`), and the row's total (`rows`).
//   4. cc_tile_scan: one block a frame, a thread a row, turns the rows'
//      totals into their exclusive prefix sum, which gives count[b].
//   5. cc_tile_write: each warp rebuilds its tile's local union-find from
//      the mask (cheaper than storing and re-reading 64 MB of local labels),
//      resolves each local root once to its global root G, whose label is
//      1 + rows[row(G)] + offsets[segment(G)] + the roots before G in its
//      segment (__popcll of the segment's bits below G), and writes every
//      pixel's label once, 16 bytes a lane, a row's 256 bytes by 16 lanes,
//      with streaming stores (nothing reads them back here).
// Device memory sees the mask read twice, the labels written once, and
// sparse nodes, bits and offsets.
// Indices are frame-local int32; addresses add the frame's base as a 64-bit
// offset, so B*H*W may exceed 2^31 while H*W may not.  Sides that are not
// multiples of the tile take the bounds-checked loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32, TW = 64;                  // tile rows (one a lane), columns (one word)
constexpr int RUNS = 32, NODES = TH * RUNS;      // at most 32 runs in a row of 64
constexpr int TILES = 4, THREADS = 32 * TILES;  // tiles (warps) a block
constexpr int SCAN_THREADS = 1024;
constexpr long long MAX_BLOCKS = 132 * 64;       // grid-stride kernels

typedef unsigned long long u64;

// ---- tile-local union-find in shared memory --------------------------------

__device__ __forceinline__ int find_local(volatile int* l, int x) {
  int px = l[x];
  while (px != x) {
    x = px;
    px = l[x];
  }
  return x;
}

__device__ __forceinline__ void unite_local(int* l, int a, int b) {
  volatile int* v = l;
  while (true) {
    a = find_local(v, a);
    b = find_local(v, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(l + b, a);
    if (old == b) return;
    b = old;
  }
}

// The run (index in its row) that holds the foreground column c, from the
// row's run starts.
__device__ __forceinline__ int run_of(u64 starts, int c) {
  return __popcll(starts & (~0ull >> (63 - c))) - 1;
}

// Four mask bytes (0 or 1) -> four bits, byte k to bit k.
__device__ __forceinline__ unsigned pack4(unsigned x) {
  return ((x * 0x01020408u) >> 24) & 0xFu;
}

// Shared memory of one tile.
struct Tile {
  u64 rows[TH];           // row bits, 0 outside the frame
  int l[NODES];           // union-find over the runs
  uint8_t col[NODES];     // a run's first column
};

// Where a tile of the batch lies, and whether it takes 16-byte loads.
struct TileAt {
  int b, y0, x0, tx;
  bool vec;
};

__device__ __forceinline__ TileAt locate(long long tile, int n_tiles, int tiles_x, int h,
                                         int w, bool vec) {
  TileAt a;
  a.b = (int)(tile / n_tiles);
  const int rem = (int)(tile - (long long)a.b * n_tiles);
  a.tx = rem % tiles_x;
  a.y0 = rem / tiles_x * TH;
  a.x0 = a.tx * TW;
  a.vec = vec && a.y0 + TH <= h && a.x0 + TW <= w;
  return a;
}

// The tile's mask as four 16-byte loads a lane (lanes 4r .. 4r + 3 of
// load k hold row 8k + r), issued before the previous tile is processed.
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ mask, const TileAt& a, int h,
                                      int w, uint4 (&v)[4]) {
  if (!a.vec) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* mf = mask + (long long)a.b * h * w + (long long)a.y0 * w + a.x0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = k * 32 + lane;
    v[k] = __ldg(reinterpret_cast<const uint4*>(mf + (long long)(idx >> 2) * w + (idx & 3) * 16));
  }
}

// The calling warp's tile: leaves the row bits in t.rows (0 outside the
// frame) and, at each run's node, its local root, the node of the run that
// holds the local component's smallest index: the same in every call
// whatever order the lanes run in.  `v` holds the tile's mask when a.vec,
// else it is read here byte by byte.  Returns the lane's row word.
__device__ u64 build_tile(const uint8_t* __restrict__ mask, const TileAt& a, int h, int w,
                         int conn, const uint4 (&v)[4], Tile& t) {
  const int lane = threadIdx.x & 31;
  uint16_t* quarters = reinterpret_cast<uint16_t*>(t.rows);   // 16 columns each
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = k * 32 + lane, r = idx >> 2, c0 = (idx & 3) * 16;
    unsigned bits = 0;
    if (a.vec) {
      bits = pack4(v[k].x) | pack4(v[k].y) << 4 | pack4(v[k].z) << 8 | pack4(v[k].w) << 12;
    } else if (a.y0 + r < h) {
      const uint8_t* row = mask + (long long)a.b * h * w + (long long)(a.y0 + r) * w;
      for (int j = 0; j < 16 && a.x0 + c0 + j < w; ++j)
        bits |= (unsigned)(row[a.x0 + c0 + j] != 0) << j;
    }
    quarters[idx] = (uint16_t)bits;
  }
  __syncwarp();
  const u64 R = t.rows[lane];
  const u64 S = R & ~(R << 1);                          // run starts
  const int me = lane * RUNS, n_runs = __popcll(S);
  {
    int k = 0;
    for (u64 x = S; x; x &= x - 1, ++k) {
      t.l[me + k] = me + k;
      t.col[me + k] = (uint8_t)(__ffsll((long long)x) - 1);
    }
  }
  __syncwarp();
  if (lane > 0 && R) {
    const u64 U = t.rows[lane - 1], SU = U & ~(U << 1);
    const int up = me - RUNS;
    const u64 O = R & U;
    for (u64 x = O & ~(O << 1); x; x &= x - 1) {          // one union a contact segment
      const int c = __ffsll((long long)x) - 1;
      unite_local(t.l, me + run_of(S, c), up + run_of(SU, c));
    }
    if (conn == 2) {                                     // diagonal-only contacts
      for (u64 x = R & ~U & ~(R << 1) & (U << 1); x; x &= x - 1) {
        const int c = __ffsll((long long)x) - 1;
        unite_local(t.l, me + run_of(S, c), up + run_of(SU, c - 1));
      }
      for (u64 x = R & ~U & ~(R >> 1) & (U >> 1); x; x &= x - 1) {
        const int c = __ffsll((long long)x) - 1;
        unite_local(t.l, me + run_of(S, c), up + run_of(SU, c + 1));
      }
    }
  }
  __syncwarp();
  for (int k = 0; k < n_runs; ++k) t.l[me + k] = find_local(t.l, me + k);
  __syncwarp();
  return R;
}

// Frame index of a node's run start.
__device__ __forceinline__ int node_index(const Tile& t, int node, int g0, int w) {
  return g0 + node / RUNS * w + t.col[node];
}

// ---- union-find in device memory -------------------------------------------

// Parents are read with __ldcg (cached in L2 only): the L1 of another SM
// would keep a parent that an atomicMin in L2 has since lowered.
__device__ __forceinline__ int find_root(int* __restrict__ p, int x) {
  int px = __ldcg(p + x);
  while (px != x) {
    const int gp = __ldcg(p + px);
    if (gp != px) atomicMin(p + x, gp);  // path halving, never upwards
    x = px;
    px = gp;
  }
  return x;
}

__device__ __forceinline__ void unite(int* __restrict__ p, int a, int b) {
  while (true) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(p + b, a);  // link the larger root under the smaller
    if (old == b) return;                 // b was still a root: linked
    b = old;                              // b was linked meanwhile: join a with its new parent
  }
}

// ---- the five passes -------------------------------------------------------

// Each warp walks the batch's tiles with a stride of the grid's warps,
// loading the next tile's mask before it builds the current one, and calls
// body(a, R) on each tile after build_tile.
template <typename Body>
__device__ __forceinline__ void tile_loop(const uint8_t* __restrict__ mask, Tile& t, int B,
                                          int h, int w, int tiles_x, int n_tiles, int conn,
                                          bool vec, Body body) {
  const long long total = (long long)B * n_tiles, stride = (long long)gridDim.x * TILES;
  long long tile = (long long)blockIdx.x * TILES + (threadIdx.x >> 5);
  if (tile >= total) return;
  TileAt a = locate(tile, n_tiles, tiles_x, h, w, vec);
  uint4 v[4];
  fetch(mask, a, h, w, v);
  while (true) {
    const long long next = tile + stride;
    const bool more = next < total;
    TileAt na = a;
    uint4 nv[4];
    if (more) {
      na = locate(next, n_tiles, tiles_x, h, w, vec);
      fetch(mask, na, h, w, nv);
    }
    body(a, build_tile(mask, a, h, w, conn, v, t));
    if (!more) return;
    __syncwarp();
    tile = next;
    a = na;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = nv[k];
  }
}

__global__ void __launch_bounds__(THREADS) cc_tile_local(
    const uint8_t* __restrict__ mask, int* __restrict__ parent, u64* __restrict__ bits, int B,
    int h, int w, int tiles_x, int n_tiles, int conn, int vec) {
  __shared__ Tile tiles[TILES];
  const int lane = threadIdx.x & 31;
  Tile& t = tiles[threadIdx.x >> 5];
  tile_loop(mask, t, B, h, w, tiles_x, n_tiles, conn, vec, [&](const TileAt& a, u64 R) {
    const int rows_in = min(TH, h - a.y0), cols_in = min(TW, w - a.x0);
    int* p = parent + (long long)a.b * h * w;
    const int g0 = a.y0 * w + a.x0;                    // frame index of the tile's corner
    // local roots: their bits, and parent[g] = g
    const u64 S = R & ~(R << 1);
    u64 roots = 0;
    int k = 0;
    for (u64 x = S; x; x &= x - 1, ++k) {
      const int node = lane * RUNS + k;
      if (t.l[node] == node) {
        const int c = __ffsll((long long)x) - 1;
        roots |= 1ull << c;
        p[g0 + lane * w + c] = g0 + lane * w + c;
      }
    }
    if (lane < rows_in) bits[((long long)a.b * h + a.y0 + lane) * tiles_x + a.tx] = roots;
    // the foreground pixels of the tile's edges point at their local root
    const int edge_rows[2] = {0, rows_in - 1};
    for (int e = 0; e < 2; ++e) {
      const int r = edge_rows[e];
      const u64 Re = t.rows[r], Se = Re & ~(Re << 1);
      for (int c = lane; c < cols_in; c += 32)
        if (Re >> c & 1) p[g0 + r * w + c] = node_index(t, t.l[r * RUNS + run_of(Se, c)], g0, w);
    }
    const int edge_cols[2] = {0, cols_in - 1};
    for (int e = 0; e < 2; ++e) {
      const int c = edge_cols[e];
      if (lane < rows_in && (R >> c & 1))
        p[g0 + lane * w + c] = node_index(t, t.l[lane * RUNS + run_of(S, c)], g0, w);
    }
  });
}

__global__ void __launch_bounds__(THREADS) cc_tile_merge(
    const uint8_t* __restrict__ mask, int* __restrict__ parent, int B, int h, int w,
    int tiles_x, int tiles_y, int conn) {
  const long long n_rows = (long long)(tiles_y - 1) * w;     // pixels on horizontal boundaries
  const long long per = n_rows + (long long)(tiles_x - 1) * h;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < (long long)B * per;
       t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / per;
    long long k = t - b * per;
    const uint8_t* m = mask + b * h * w;
    int* p = parent + b * h * w;
    if (k < n_rows) {
      // pixel pi in a tile's first row, qi above it in the tile row above
      const int r = (int)(k / w + 1) * TH, c = (int)(k % w);
      const int pi = r * w + c, qi = pi - w;
      if (!m[pi]) continue;
      const bool up = m[qi];
      const bool inner_l = c % TW != 0;                      // c - 1 in the same two tiles
      if (up && !(inner_l && m[pi - 1] && m[qi - 1])) unite(p, pi, qi);
      if (conn == 2) {
        if (c > 0 && m[qi - 1] && !(inner_l && (up || m[pi - 1]))) unite(p, pi, qi - 1);
        const bool inner_r = (c + 1) % TW != 0;              // c + 1 in the same two tiles
        if (c + 1 < w && m[qi + 1] && !(inner_r && (up || m[pi + 1]))) unite(p, pi, qi + 1);
      }
    } else {
      // pixel pi in a tile's first column, qi left of it; diagonals only
      // within the tile row (the row pass has the pairs across tile rows)
      k -= n_rows;
      const int r = (int)(k % h), c = (int)(k / h + 1) * TW;
      const int pi = r * w + c, qi = pi - 1;
      if (!m[pi]) continue;
      const bool left = m[qi];
      const bool inner_u = r % TH != 0;                      // r - 1 in the same tile row
      if (left && !(inner_u && m[pi - w] && m[qi - w])) unite(p, pi, qi);
      if (conn == 2) {
        if (inner_u && m[qi - w] && !(left || m[pi - w])) unite(p, pi, qi - w);
        if (r + 1 < h && (r + 1) % TH != 0 && m[qi + w] && !(left || m[pi + w]))
          unite(p, pi, qi + w);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) cc_tile_roots(
    const int* __restrict__ parent, u64* __restrict__ bits, int* __restrict__ offsets,
    int* __restrict__ row_roots, long long n_rows, int h, int w, int tiles_x) {
  const int lane = threadIdx.x & 31;
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < n_rows;
       row += ((long long)gridDim.x * blockDim.x) >> 5) {
    const int* p = parent + row / h * h * w;
    const int r = (int)(row % h);
    int carry = 0;
    for (int x0 = 0; x0 < tiles_x; x0 += 32) {
      const int tx = x0 + lane;
      int n = 0;
      if (tx < tiles_x) {
        const long long s = row * tiles_x + tx;
        const u64 word = bits[s];
        const int g0 = r * w + tx * TW;
        u64 keep = 0;
        for (u64 x = word; x; x &= x - 1) {
          const int c = __ffsll((long long)x) - 1;
          if (__ldcg(p + g0 + c) == g0 + c) keep |= 1ull << c;
        }
        if (keep != word) bits[s] = keep;
        n = __popcll(keep);
      }
      int incl = n;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (tx < tiles_x) offsets[row * tiles_x + tx] = carry + incl - n;   // within the row
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) row_roots[row] = carry;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) cc_tile_scan(int* __restrict__ row_roots,
                                                           int* __restrict__ count, int h) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ int round_end;
  int* rows = row_roots + (long long)blockIdx.x * h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;   // the roots of the rows of the rounds before
  for (int r0 = 0; r0 < h; r0 += SCAN_THREADS) {
    const int r = r0 + threadIdx.x;
    const int n = r < h ? rows[r] : 0;
    int incl = n;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int ws = warp_sums[lane];
      int wincl = ws;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, wincl, d);
        if (lane >= d) wincl += v;
      }
      warp_sums[lane] = wincl - ws;   // exclusive prefix of the warps
    }
    __syncthreads();
    const int before = carry + warp_sums[warp] + incl - n;
    if (r < h) rows[r] = before;      // the row's first label - 1
    if (threadIdx.x == SCAN_THREADS - 1) round_end = before + n;
    __syncthreads();
    carry = round_end;
    __syncthreads();
  }
  if (threadIdx.x == 0) count[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS) cc_tile_write(
    const uint8_t* __restrict__ mask, const int* __restrict__ parent,
    const u64* __restrict__ bits, const int* __restrict__ offsets,
    const int* __restrict__ row_first, int* __restrict__ out, int B, int h, int w, int tiles_x,
    int n_tiles, int conn, int vec, int vec_out) {
  __shared__ Tile tiles[TILES];
  const int lane = threadIdx.x & 31;
  Tile& t = tiles[threadIdx.x >> 5];
  tile_loop(mask, t, B, h, w, tiles_x, n_tiles, conn, vec, [&](const TileAt& a, u64 R) {
    const long long base = (long long)a.b * h * w, row_base = (long long)a.b * h;
    const int* p = parent + base;
    // each local root's label, stored negated at its own node
    const int n_runs = __popcll(R & ~(R << 1));
    for (int k = 0; k < n_runs; ++k) {
      const int node = lane * RUNS + k;
      if (t.l[node] != node) continue;
      int g = node_index(t, node, a.y0 * w + a.x0, w), pg;
      while ((pg = __ldcg(p + g)) != g) g = pg;             // the global root
      const int gr = g / w, gc = g - gr * w;
      const long long s = (row_base + gr) * tiles_x + gc / TW;
      t.l[node] = -(1 + row_first[row_base + gr] + offsets[s] +
                    __popcll(bits[s] & ((1ull << (gc % TW)) - 1)));
    }
    __syncwarp();
    const int rows_in = min(TH, h - a.y0), cols_in = min(TW, w - a.x0);
    int* o = out + base + (long long)a.y0 * w + a.x0;
    // 16 lanes a row, four pixels a lane
    for (int k = 0; k < TH / 2; ++k) {
      const int r = 2 * k + (lane >> 4), c0 = (lane & 15) * 4;
      const u64 Rr = t.rows[r], Sr = Rr & ~(Rr << 1);
      int lab[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lab[j] = 0;
        if (Rr >> (c0 + j) & 1) {
          const int x = t.l[r * RUNS + run_of(Sr, c0 + j)];
          lab[j] = x < 0 ? -x : -t.l[x];
        }
      }
      if (vec_out && rows_in == TH && cols_in == TW) {
        __stcs(reinterpret_cast<int4*>(o + (long long)r * w + c0),   // streaming: no reuse
               make_int4(lab[0], lab[1], lab[2], lab[3]));
      } else if (r < rows_in) {
        for (int j = 0; j < 4 && c0 + j < cols_in; ++j) o[(long long)r * w + c0 + j] = lab[j];
      }
    }
  });
}

long long grid_stride_blocks(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
}

// Blocks of a persistent tile kernel: as many as fit on the device at once
// (asked once a kernel; the grid's size moves only the speed).
template <typename K>
unsigned resident_blocks(K kernel, long long tiles, int& fit) {
  if (fit <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (tiles + TILES - 1) / TILES;
  return (unsigned)(need < fit ? need : fit);
}

int fit_local = 0, fit_write = 0;

}  // namespace

// Five launches on `stream`; H * W < 2^31, H, W >= 1; the mask's bytes
// are 0 or 1 (torch.bool).  Scratch: parent (B, H, W) int32; bits
// (B, H, ceil(W/64)) uint64; offsets likewise int32; rows (B, H) int32.
extern "C" int cia_cc_label_components(const void* mask, void* parent, void* bits,
                                       void* offsets, void* rows, void* out, void* count,
                                       int B, int h, int w, int conn, void* stream) {
  if (B <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int n_tiles = tiles_x * tiles_y;
  const int vec = w % 16 == 0 && ((uintptr_t)mask & 15) == 0;
  const int vec_out = w % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const uint8_t* m = (const uint8_t*)mask;
  int* p = (int*)parent;
  u64* bw = (u64*)bits;
  int* off = (int*)offsets;
  int* rr = (int*)rows;
  const long long all_tiles = (long long)B * n_tiles;
  cc_tile_local<<<resident_blocks(cc_tile_local, all_tiles, fit_local), THREADS, 0, s>>>(
      m, p, bw, B, h, w, tiles_x, n_tiles, conn, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long boundary = (long long)B * ((long long)(tiles_y - 1) * w +
                                              (long long)(tiles_x - 1) * h);
  cc_tile_merge<<<(unsigned)grid_stride_blocks(boundary), THREADS, 0, s>>>(
      m, p, B, h, w, tiles_x, tiles_y, conn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_rows = (long long)B * h;
  cc_tile_roots<<<(unsigned)grid_stride_blocks(n_rows * 32), THREADS, 0, s>>>(
      p, bw, off, rr, n_rows, h, w, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_tile_scan<<<(unsigned)B, SCAN_THREADS, 0, s>>>(rr, (int*)count, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_tile_write<<<resident_blocks(cc_tile_write, all_tiles, fit_write), THREADS, 0, s>>>(
      m, p, bw, off, rr, (int*)out, B, h, w, tiles_x, n_tiles, conn, vec, vec_out);
  return (int)cudaGetLastError();
}
