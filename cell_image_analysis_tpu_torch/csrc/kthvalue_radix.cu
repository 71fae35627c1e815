// Exact k-th smallest elements of each frame: a batched radix select.
//
// Replaces: no Pallas kernel.  It replaces `torch.kthvalue`, which the port
//   had called for the counterpart of the JAX package's sort-free XLA
//   bisection (cell_image_analysis_tpu/ops/percentile.py, kth_smallest).
//   torch.kthvalue gives each frame one thread block, so 2 frames of 4096^2
//   kept 2 of the card's 132 SMs busy (119.5 ms a call).
//
// What bounds it on the H100: bytes.  The least work is one read of the
// frames (2 x 4096^2 float32 = 134 MB: 40 us at 3.35 TB/s); a radix select
// reads them once a digit, three times.  The design keeps every read at the
// card's rate: every frame is shared by as many blocks as fill the SMs,
// loads are 16 bytes a thread, all of a frame's ranks are resolved in the
// same read, and nothing but histograms and a few counters touches device
// memory besides the frames.
//
// Design: each float32 maps to its order-preserving uint32 key (negative:
// every bit flipped; positive: the sign bit set; every NaN to 0xFFC00000,
// above +inf, as torch.sort and torch.kthvalue order them).  The key's
// three digits, 11 + 11 + 10 bits from the top, are found in three passes
// (`kthvalue_radix_pass<0..2>`).  A pass histograms the digit in shared
// memory, counting only the elements whose higher digits match the prefix
// found so far for one of the frame's ranks (every element in pass 0), and
// adds its nonzero bins to the frame's histogram in device memory.  The
// last block of a frame to finish (a counter a frame and pass) scans that
// histogram: for each rank the bin where the running count passes the rank
// extends its prefix, and the rank within the bin carries to the next pass;
// after pass 2 the prefix is the whole key, whose float is written.  Ranks
// with one prefix share one histogram row.  The passes are bound by the
// instructions they issue for each element, so passes 1 and 2 find a key's
// row with one shared-memory read (a table by top digit, checked against
// the prefix's lower digits), read for 16 elements before any branch.
// Image data crowd few top bins, so a thread adds runs of equal bins in one
// atomic, and pass 0 keeps four copies of each bin (lane mod 4) so that
// lanes of one warp rarely add to one address.  `kthvalue_radix_init` zeroes the histograms and counters
// and seeds the ranks: no memset, no host synchronisation.  The selected
// key is the element's own, so the value is bit-exact (-0.0 orders below
// +0.0; every NaN reads as 0x7FC00000).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 8;    // distinct ranks and output columns of one call
constexpr int ROW = 2048;       // a histogram row: the widest digit's bins
constexpr int COPIES = 4;       // pass 0's copies of each bin
constexpr int UNROLL = 4;       // float4 loads in flight a thread
constexpr int PASSES = 3;
// passes 1, 2: a top digit's entry, (row << 12) | the prefix's digits below
// the top one (none in pass 1); NO_ENTRY and COLLIDED (two rows) hold a
// check that no key matches
constexpr unsigned NO_ENTRY = 0x0FFF, COLLIDED = 0x8FFF;

struct FrameState {             // a frame's ranks before a pass
  unsigned prefix[MAX_RANKS];   // the key's digits found so far
  unsigned rank[MAX_RANKS];     // the rank among the keys with that prefix
};

struct Ranks {
  unsigned k[MAX_RANKS];        // the distinct ranks
  int col[MAX_RANKS];           // output column j takes the rank k[col[j]]
  int n_ranks, n_cols;
};

template <int PASS> struct Digit;
template <> struct Digit<0> { static constexpr int SHIFT = 21, BITS = 11; };
template <> struct Digit<1> { static constexpr int SHIFT = 10, BITS = 11; };
template <> struct Digit<2> { static constexpr int SHIFT = 0, BITS = 10; };

__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned key = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  return v != v ? 0xFFC00000u : key;
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void kthvalue_radix_init(unsigned* __restrict__ hist, long long hist_words,
                                    unsigned* __restrict__ counters, int n_counters,
                                    FrameState* __restrict__ state, int frames, Ranks rk) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < hist_words; i += stride) hist[i] = 0;
  for (long long i = first; i < n_counters; i += stride) counters[i] = 0;
  for (long long i = first; i < (long long)frames * MAX_RANKS; i += stride) {
    const int r = (int)(i % MAX_RANKS);
    state[i / MAX_RANKS].prefix[r] = 0;
    state[i / MAX_RANKS].rank[r] = r < rk.n_ranks ? rk.k[r] : 0;
  }
}

// One digit pass over frame blockIdx.y, shared by gridDim.x blocks.
// `state` holds PASSES + 1 rows of `frames` FrameStates: the pass reads row
// PASS, its last block of the frame writes row PASS + 1 (or, after pass 2,
// the values to `out`).  `hist` is the pass's (frames, n_ranks, ROW), zero.
template <int PASS>
__global__ void __launch_bounds__(THREADS, 4)
kthvalue_radix_pass(const float* __restrict__ x, long long n, unsigned* __restrict__ hist,
                    unsigned* __restrict__ counters, FrameState* __restrict__ state,
                    float* __restrict__ out, long long ld_out, Ranks rk) {
  constexpr int SHIFT = Digit<PASS>::SHIFT, BITS = Digit<PASS>::BITS;
  constexpr int BINS = 1 << BITS;
  constexpr int PER = BINS / THREADS;           // bins a thread scans
  extern __shared__ unsigned sh[];              // pass 0: BINS x COPIES, else n_ranks x BINS
  __shared__ unsigned s_prefix[MAX_RANKS], s_rank[MAX_RANKS];
  __shared__ unsigned s_next_prefix[MAX_RANKS], s_next_rank[MAX_RANKS];
  __shared__ int s_owner[MAX_RANKS];            // the first rank with the same prefix
  __shared__ __align__(16) unsigned short s_entry[ROW];  // passes 1, 2: a top digit's entry
  __shared__ unsigned s_warp[THREADS / 32];
  __shared__ int s_last, s_collided;

  const int frames = gridDim.y, frame = blockIdx.y, t = threadIdx.x;
  const int n_ranks = rk.n_ranks;
  const FrameState* st = state + (long long)PASS * frames + frame;
  if (t < MAX_RANKS) {
    s_prefix[t] = st->prefix[t];
    s_rank[t] = st->rank[t];
  }
  const int words = PASS == 0 ? BINS * COPIES : n_ranks * BINS;
  for (int i = t; i < words; i += THREADS) sh[i] = 0;
  // the bits of a prefix below its top digit: none in pass 1, 11 in pass 2
  constexpr int LOW = 21 - SHIFT - BITS;
  if constexpr (PASS > 0)
    for (int i = t; i < ROW / 2; i += THREADS)
      reinterpret_cast<unsigned*>(s_entry)[i] = NO_ENTRY | NO_ENTRY << 16;
  __syncthreads();
  if (t == 0) {
    // a rank's row is that of the first rank with its prefix
    s_collided = 0;
    for (int r = 0; r < n_ranks; ++r) {
      int o = r;
      for (int q = 0; q < r; ++q)
        if (s_prefix[q] == s_prefix[r]) { o = q; break; }
      s_owner[r] = o;
      if constexpr (PASS > 0) {
        if (o == r) {
          unsigned short& e = s_entry[s_prefix[r] >> LOW];
          s_collided |= e != NO_ENTRY;
          e = e == NO_ENTRY ? (unsigned short)(r << 12 | (s_prefix[r] & ((1u << LOW) - 1)))
                            : (unsigned short)COLLIDED;
        }
      }
    }
  }
  __syncthreads();

  // the distinct prefixes in registers, for a collided entry; an unused
  // entry never matches, since a prefix has at most 22 bits
  unsigned match[MAX_RANKS];
#pragma unroll
  for (int r = 0; r < MAX_RANKS; ++r)
    match[r] = (r < n_ranks && s_owner[r] == r) ? s_prefix[r] : 0xFFFFFFFFu;

  int cur = -1;        // the bin of the thread's current run, and its length
  unsigned run = 0;
  // one more element in bin idx where `hit`: a run of one bin goes to
  // shared memory in one atomic when it ends (predicated, no branch)
  auto add = [&](bool hit, int idx) {
    const bool ends = hit && idx != cur;
    if (ends && run) atomicAdd(sh + cur, run);
    run = ends ? 1u : run + hit;
    cur = hit ? idx : cur;
  };
  const int copy = t & (COPIES - 1);

  // The block's elements of the frame.  Passes 1, 2 count a key where its
  // digits above the pass's are a rank's prefix: its top digit's entry
  // names the row and holds the prefix's lower digits; `collided` (a
  // block-uniform choice) where an entry has two rows.  16-byte loads from
  // the frame's first 16-byte boundary; the elements before it and after
  // the last whole float4 go to block 0.
  const float* xf = x + (long long)frame * n;
  const long long head = min(n, (long long)(((16 - ((size_t)xf & 15)) & 15) >> 2));
  const float4* x4 = reinterpret_cast<const float4*>(xf + head);
  const long long n4 = (n - head) >> 2;
  const long long stride = (long long)gridDim.x * THREADS;
  auto sweep = [&](auto collided) {
    auto lookup = [&](unsigned key) -> unsigned { return PASS == 0 ? 0u : s_entry[key >> 21]; };
    auto visit = [&](unsigned key, unsigned entry) {
      if constexpr (PASS == 0) {
        add(true, (int)(key >> SHIFT) * COPIES + copy);
      } else {
        const unsigned hi = key >> (SHIFT + BITS);
        bool hit = (entry & 0xFFF) == (hi & ((1u << LOW) - 1));
        int r = (int)(entry >> 12);
        if constexpr (decltype(collided)::value) {
          if (entry == COLLIDED) {
#pragma unroll
            for (int q = 0; q < MAX_RANKS; ++q)
              if (hi == match[q]) {
                r = q;
                hit = true;
              }
          }
        }
        add(hit, r * BINS + (int)((key >> SHIFT) & (BINS - 1)));
      }
    };
    auto consume = [&](float v) {
      const unsigned key = float_key(v);
      visit(key, lookup(key));
    };
    long long i = (long long)blockIdx.x * THREADS + t;
    for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
      // the loads, then the keys and their entries, then the visits: no
      // shared-memory read waits in the middle of the visits
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(x4 + i + u * stride);
      unsigned key[4 * UNROLL], entry[4 * UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        key[4 * u] = float_key(v[u].x);
        key[4 * u + 1] = float_key(v[u].y);
        key[4 * u + 2] = float_key(v[u].z);
        key[4 * u + 3] = float_key(v[u].w);
      }
#pragma unroll
      for (int j = 0; j < 4 * UNROLL; ++j) entry[j] = lookup(key[j]);
#pragma unroll
      for (int j = 0; j < 4 * UNROLL; ++j) visit(key[j], entry[j]);
    }
    for (; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      consume(v.x);
      consume(v.y);
      consume(v.z);
      consume(v.w);
    }
    if (blockIdx.x == 0) {
      const long long tail = head + 4 * n4;
      if (t < head) consume(xf[t]);
      if (t < n - tail) consume(xf[tail + t]);
    }
  };
  if (PASS > 0 && s_collided)
    sweep(std::true_type{});
  else
    sweep(std::false_type{});
  if (run) atomicAdd(sh + cur, run);
  __syncthreads();

  unsigned* fh = hist + (long long)frame * n_ranks * ROW;
  if constexpr (PASS == 0) {
    for (int b = t; b < BINS; b += THREADS) {
      unsigned c = 0;
#pragma unroll
      for (int j = 0; j < COPIES; ++j) c += sh[b * COPIES + j];
      if (c) atomicAdd(fh + b, c);
    }
  } else {
    for (int w = t; w < n_ranks * BINS; w += THREADS) {
      const unsigned c = sh[w];
      if (c) atomicAdd(fh + (w / BINS) * ROW + (w % BINS), c);
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(counters + PASS * frames + frame, 1u) == (unsigned)(gridDim.x - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The frame's last block: every block has added its bins.  For each row
  // (an owner rank), an exclusive scan of its bins over the block; the
  // thread whose bins hold a rank walks them to the digit.
  for (int s = 0; s < n_ranks; ++s) {
    if (s_owner[s] != s) continue;
    const unsigned* row = fh + s * ROW + t * PER;
    unsigned h[PER];
    unsigned local = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      h[j] = __ldcg(row + j);
      local += h[j];
    }
    unsigned incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if ((t & 31) >= o) incl += y;
    }
    if ((t & 31) == 31) s_warp[t >> 5] = incl;
    __syncthreads();
    unsigned base = incl - local;
    for (int w = 0; w < (t >> 5); ++w) base += s_warp[w];
    for (int r = s; r < n_ranks; ++r) {
      if (s_owner[r] != s) continue;
      const unsigned k = s_rank[r];
      if (k >= base && k - base < local) {
        unsigned c = base;
        int d = -1;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (d < 0) {
            if (k - c < h[j]) d = j;
            else c += h[j];
          }
        }
        s_next_prefix[r] = (s_prefix[r] << BITS) | (unsigned)(t * PER + d);
        s_next_rank[r] = k - c;
      }
    }
    __syncthreads();
  }

  if constexpr (PASS + 1 < PASSES) {
    FrameState* next = state + (long long)(PASS + 1) * frames + frame;
    if (t < n_ranks) {
      next->prefix[t] = s_next_prefix[t];
      next->rank[t] = s_next_rank[t];
    }
  } else if (t < rk.n_cols) {
    out[frame * ld_out + t] = key_float(s_next_prefix[rk.col[t]]);
  }
}

// one pass's histograms
long long hist_words(int frames, int n_ranks) { return (long long)frames * n_ranks * ROW; }

template <int PASS>
cudaError_t launch_pass(const float* x, long long n, int frames, int blocks_per_frame,
                        unsigned* hist, unsigned* counters, FrameState* state, float* out,
                        long long ld_out, const Ranks& rk, cudaStream_t stream) {
  constexpr int BINS = 1 << Digit<PASS>::BITS;
  const int smem = (PASS == 0 ? BINS * COPIES : rk.n_ranks * BINS) * (int)sizeof(unsigned);
  // above 48 KB less the static shared memory only with this attribute
  const cudaError_t e = cudaFuncSetAttribute(
      kthvalue_radix_pass<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kthvalue_radix_pass<PASS><<<dim3(blocks_per_frame, frames), THREADS, smem, stream>>>(
      x, n, hist, counters, state, out, ld_out, rk);
  return cudaGetLastError();
}

}  // namespace

// 32-bit words of scratch a call needs: the histograms, a counter a frame
// and pass, and the frames' rank states before each pass and after the last.
extern "C" int cia_kthvalue_radix_scratch_words(int frames, int n_ranks) {
  return (int)(PASSES * hist_words(frames, n_ranks) + (long long)PASSES * frames +
               (long long)(PASSES + 1) * frames * (long long)(sizeof(FrameState) / 4));
}

// The ranks `ranks[0..n_ranks)` (distinct, each < n) of each of `frames`
// contiguous float32 frames of n elements at x; out[f * ld_out + j] gets
// the rank ranks[cols[j]] of frame f, for j < n_cols.  `ranks` and `cols`
// are host arrays; `scratch` holds cia_kthvalue_radix_scratch_words(frames,
// n_ranks) words, 16-byte aligned, of any content.
extern "C" int cia_kthvalue_radix(const void* x, long long n, int frames, int blocks_per_frame,
                                  const void* ranks, int n_ranks, const void* cols, int n_cols,
                                  void* out, long long ld_out, void* scratch, void* stream) {
  if (frames <= 0 || n <= 0 || n_ranks <= 0 || n_cols <= 0) return (int)cudaGetLastError();
  if (n_ranks > MAX_RANKS || n_cols > MAX_RANKS || blocks_per_frame <= 0 || frames > 65535)
    return (int)cudaErrorInvalidValue;
  Ranks rk;
  for (int r = 0; r < MAX_RANKS; ++r) {
    rk.k[r] = r < n_ranks ? (unsigned)((const long long*)ranks)[r] : 0u;
    rk.col[r] = r < n_cols ? ((const int*)cols)[r] : 0;
  }
  rk.n_ranks = n_ranks;
  rk.n_cols = n_cols;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long hw = hist_words(frames, n_ranks);
  unsigned* hist = (unsigned*)scratch;
  unsigned* counters = hist + PASSES * hw;
  FrameState* state = (FrameState*)(counters + PASSES * frames);
  const float* xf = (const float*)x;
  float* o = (float*)out;

  long long blocks = (PASSES * hw + THREADS - 1) / THREADS;
  if (blocks > 1024) blocks = 1024;
  kthvalue_radix_init<<<(unsigned)blocks, THREADS, 0, s>>>(
      hist, PASSES * hw, counters, PASSES * frames, state, frames, rk);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_pass<0>(xf, n, frames, blocks_per_frame, hist, counters, state, o, ld_out, rk, s);
  if (e == cudaSuccess)
    e = launch_pass<1>(xf, n, frames, blocks_per_frame, hist + hw, counters, state, o, ld_out,
                       rk, s);
  if (e == cudaSuccess)
    e = launch_pass<2>(xf, n, frames, blocks_per_frame, hist + 2 * hw, counters, state, o,
                       ld_out, rk, s);
  return (int)e;
}
