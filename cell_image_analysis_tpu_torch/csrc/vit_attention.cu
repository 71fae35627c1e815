// Global attention of a ViT block with SAM's decomposed relative-position
// bias, flash-style, 3xTF32 on the tensor cores with wgmma.
//
// Replaces: nothing of the JAX package, which has no ViT.  The source is
// Cellpose-SAM (MouseLand/cellpose 4, `vit_sam.Transformer`: SAM's ViT-L
// image encoder with every block's window set to 0), whose attention is,
// for each of the B x 16 heads over the N = 32 x 32 tokens of a tile,
//
//     softmax((q scale) k^T + rel_h[q, k_row] + rel_w[q, k_col]) v
//
// with rel_h (N, N / 32) and rel_w (N, 32) formed before the call from the
// unscaled q and the resized tables (SAM's `add_decomposed_rel_pos`).  The
// bias is added inside the kernel: no N x N score matrix reaches device
// memory (64 MB a tile and block materialised, 6.4 GB at 100 tiles).
//
// Accuracy: each product runs as 3xTF32, as in csrc/winograd_conv3x3.cu:
// hi = x rounded to TF32 (cvt.rna), lo = the TF32 rounding of x - hi, and
// the three larger cross products lo*hi + hi*lo + hi*hi are summed in the
// float32 accumulators (~2^-22 relative a product).  The softmax is online
// in float32: each row keeps its running maximum m and sum l, a key block's
// probabilities are exp2((s - m) log2 e), and the output accumulators are
// rescaled when m grows; the output is divided by l at the end.  A key
// block's P V is summed in accumulators of its own (24 wgmma products) and
// added to the output in float32, O = alpha O + P V: the tensor cores'
// accumulation drops low bits on every product, and 384 of them chained
// into one accumulator over the 16 key blocks cost ~1e-5 of the output's
// largest value on the card (1.1e-5 against the plain form at 100 tiles x
// 16 heads, H100; ~1.7e-6 with the block's sum apart, emulated).
//
// Design (one block = 128 queries of one head, two warpgroups of 64; key
// blocks of 64 keys, two rows of 32 key tokens):
// 1. S = (q scale) K^T: wgmma m64n32k8, A = q from registers (this warp's
//    16 rows as the m16n8k8 A fragment, hi and lo, split once), B = K from
//    shared memory, K-major; the 64 keys as two n32 halves (key rows), the
//    head dimension 64 as 8 k-steps.
// 2. The bias and the online softmax in registers.  A thread holds rows g
//    and g + 8 of its warp's 16 and, in each half, key columns 8 n + 2 t +
//    {0, 1}: its 16 entries of rel_w are loaded once; rel_h is two values a
//    row and key block.
// 3. O = alpha O + P V: wgmma m64n32k8, A = P from the accumulators of step
//    1 (split into TF32 halves), B = V from shared memory; the head
//    dimension as two n32 halves, one after the other, the 64 keys as 8
//    k-steps.  An accumulator holds keys 2t and 2t + 1 of a k-step where the
//    A fragment wants t and t + 4: the sum over keys does not care about
//    their order, so the wrapper stores V
//    transposed with the keys of every group of 8 in the order (0, 2, 4, 6,
//    1, 3, 5, 7) (`vt`), and the accumulators go into the A fragment as they
//    lie, with no shuffle.
// 4. Loads: two stages of K and V (64 keys each), filled by cp.async while
//    the other is multiplied; once a stage has landed every thread splits
//    its share into the hi and lo buffers in place, then a proxy fence and
//    a barrier publish it to wgmma.  131,072 bytes of dynamic shared memory.
//
// Layouts: q, k (BH, N, 64), vt (BH, 64, N) with the keys permuted as in
// 3.; rel_h (BH, N, N / 32), rel_w (BH, N, 32); out (BH, N, 64); all
// float32, contiguous.  N must be a multiple of 128 and the key grid 32
// columns wide (N = 32 x KH).  Shared-memory operand layout (one of K_hi,
// K_lo, V_hi, V_lo): [n32 half 2][k group of 4, 16][n 32][4], the layout
// of the Winograd kernel's U stages: core matrices of 8 n x 16 bytes, 128
// bytes apart along n, 512 bytes apart along k.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int D = 64;                    // head dimension
constexpr int KW = 32;                   // key columns a key row: rel_w's width
constexpr int BQ = 128;                  // queries a block: two warpgroups of 64
constexpr int BK = 64;                   // keys a stage: two key rows
constexpr int THREADS = 256;
constexpr int HALF = 16 * 32 * 4;        // one n32 half of an operand, all 16 k groups
constexpr int OPER = 2 * HALF;           // one operand of a stage (K or V, hi or lo)
constexpr int STAGE = 4 * OPER;          // K_hi, K_lo, V_hi, V_lo
constexpr int SMEM_BYTES = 2 * STAGE * 4;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BK == 2 * KW, "a key block is two key rows");
static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory a block");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a * B: m64n32k8, TF32 operands, float32 accumulators; A from registers
// (the m16n8k8 A fragment of this warp's 16 rows), B K-major from shared memory;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], const uint32_t* a, uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// shared-memory descriptor of a K-major operand (no swizzle): core matrices of
// 8 n x 16 bytes, 128 bytes apart along n, 512 bytes apart along k
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// the descriptor offset of k step s in n32 half h of an operand, in 16-byte units
__device__ __forceinline__ uint64_t step_off(int h, int s) {
  return (uint64_t)((h * HALF + 2 * s * 128) * 4) >> 4;
}

__global__ void __launch_bounds__(THREADS, 1)
vit_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ vt, const float* __restrict__ rel_h,
                     const float* __restrict__ rel_w, float* __restrict__ out, int N, int KH,
                     float scale) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * BQ + 16 * warp + g;   // this thread's rows: row0, row0 + 8
  const float* qb = q + bh * N * D;
  const float* kb = k + bh * N * D;
  const float* vb = vt + bh * D * N;
  const float* hb = rel_h + bh * N * KH;
  const float* wb = rel_w + bh * N * KW;

  // q scaled, as the A fragment of each k step: [step][hi 0-3 | lo 4-7], element
  // i at row row0 + 8 (i & 1), column 8 step + t + 4 (i >> 1)
  uint32_t qa[8][8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = qb[(size_t)(row0 + 8 * (i & 1)) * D + 8 * s + t + 4 * (i >> 1)] * scale;
      qa[s][i] = to_tf32(x);
      qa[s][4 + i] = to_tf32(x - __uint_as_float(qa[s][i]));
    }
  // rel_w of the thread's key columns 8 n + 2 t + j: rw[row][2 n + j]
  float rw[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) rw[r][2 * n + j] = wb[(size_t)(row0 + 8 * r) * KW + 8 * n + 2 * t + j];

  auto load = [&](int blk, int st) {
    float* S = smem + st * STAGE;
    const int k0 = blk * BK;
    for (int e = tid; e < BK * D / 4; e += THREADS) {
      // four threads read one key's 64 contiguous bytes
      const int j = (e & 3) + 4 * (e >> 8), n = (e >> 2) & 63;
      cp_async16(S + (n >> 5) * HALF + j * 128 + (n & 31) * 4, kb + (size_t)(k0 + n) * D + 4 * j);
      // V: dimension n, keys k0 + 4 j .. + 3 (in vt's order)
      cp_async16(S + 2 * OPER + (n >> 5) * HALF + j * 128 + (n & 31) * 4,
                 vb + (size_t)n * N + k0 + 4 * j);
    }
  };
  // a landed stage: hi in place, lo beside it, for K and V
  auto split = [&](int st) {
    float* S = smem + st * STAGE;
    for (int e = tid; e < OPER / 4; e += THREADS) {
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        float4* hi = reinterpret_cast<float4*>(S + 2 * op * OPER) + e;
        float4* lo = reinterpret_cast<float4*>(S + (2 * op + 1) * OPER) + e;
        const float4 x = *hi;
        float4 h, l;
        h.x = __uint_as_float(to_tf32(x.x));
        h.y = __uint_as_float(to_tf32(x.y));
        h.z = __uint_as_float(to_tf32(x.z));
        h.w = __uint_as_float(to_tf32(x.w));
        l.x = __uint_as_float(to_tf32(x.x - h.x));
        l.y = __uint_as_float(to_tf32(x.y - h.y));
        l.z = __uint_as_float(to_tf32(x.z - h.z));
        l.w = __uint_as_float(to_tf32(x.w - h.w));
        *hi = h;
        *lo = l;
      }
    }
  };

  // O[half][4 n + e]: row row0 + 8 (e >> 1), dimension 32 half + 8 n + 2 t + (e & 1)
  float o[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[h][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int nblk = N / BK;
  load(0, 0);
  cp_async_commit();
  for (int blk = 0; blk < nblk; ++blk) {
    const int st = blk & 1;
    cp_async_wait_all();                 // this thread's copies of the stage landed
    __syncthreads();                     // everyone's did; the other stage is free
    split(st);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    if (blk + 1 < nblk) load(blk + 1, st ^ 1);
    cp_async_commit();

    const float* S = smem + st * STAGE;
    const uint64_t dkh = smem_desc(S), dkl = smem_desc(S + OPER);
    const uint64_t dvh = smem_desc(S + 2 * OPER), dvl = smem_desc(S + 3 * OPER);

    // 1. scores of the block's two key rows
    float sc[2][16];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t off = step_off(h, s);
        wgmma_m64n32k8(sc[h], qa[s] + 4, dkh + off, s > 0);  // small terms first
        wgmma_m64n32k8(sc[h], qa[s], dkl + off, 1);
        wgmma_m64n32k8(sc[h], qa[s], dkh + off, 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_operand(sc[h][i]);

    // 2. the bias, then the online softmax
    float rh[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) rh[r][h] = hb[(size_t)(row0 + 8 * r) * KH + 2 * blk + h];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float x = (sc[h][4 * n + e] + rh[r][h]) + rw[r][2 * n + (e & 1)];
          sc[h][4 * n + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // P as the A fragment of each k step s (keys 8 s .. + 7: half s / 4, n = s % 4):
    // a0 = (row0, key 2t), a1 = (row0 + 8, key 2t), a2 = (row0, key 2t + 1),
    // a3 = (row0 + 8, key 2t + 1)
    uint32_t pa[8][8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int h = s >> 2, n = s & 3;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f((sc[h][4 * n + e] - m[e >> 1]) * LOG2E);
        l[e >> 1] += p[e];
      }
      const float a[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[s][i] = to_tf32(a[i]);
        pa[s][4 + i] = to_tf32(a[i] - __uint_as_float(pa[s][i]));
      }
    }

    // 3. O = alpha O + P V, the block's P V summed apart (see the header)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[16];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint64_t off = step_off(h, s);
        wgmma_m64n32k8(pv, pa[s] + 4, dvh + off, s > 0);
        wgmma_m64n32k8(pv, pa[s], dvl + off, 1);
        wgmma_m64n32k8(pv, pa[s], dvh + off, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        fence_operand(pv[i]);
        o[h][i] = fmaf(o[h][i], alpha[(i >> 1) & 1], pv[i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = out + bh * N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(ob + (size_t)(row0 + 8 * r) * D + 32 * h + 8 * n + 2 * t) =
            make_float2(o[h][4 * n + 2 * r] / l[r], o[h][4 * n + 2 * r + 1] / l[r]);
}

constexpr int MAX_DEVICES = 64;  // device ordinals with a remembered attribute

}  // namespace

// q, k (BH, N, 64); vt (BH, 64, N), the keys of every group of 8 in the order
// (0, 2, 4, 6, 1, 3, 5, 7); rel_h (BH, N, KH); rel_w (BH, N, 32); out (BH, N, 64);
// float32, contiguous, 16-byte aligned; N = 32 KH, a multiple of 128
extern "C" int cia_vit_attention(const void* q, const void* k, const void* vt, const void* rel_h,
                                 const void* rel_w, void* out, int BH, int N, int KH,
                                 float scale, void* stream) {
  if (BH < 0 || BH > 65535 || N <= 0 || N % BQ || N != KW * KH)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < MAX_DEVICES) smem_set[dev] = true;
  }
  if (BH == 0) return (int)cudaGetLastError();
  dim3 grid(N / BQ, BH);
  vit_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)vt, (const float*)rel_h,
      (const float*)rel_w, (float*)out, N, KH, scale);
  return (int)cudaGetLastError();
}
