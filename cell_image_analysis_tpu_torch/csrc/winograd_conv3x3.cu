// SAME 3x3 stride-1 convolution + bias by Winograd F(2x2, 3x3), 3xTF32 on
// the tensor cores with wgmma.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/winograd.py,
//   winograd_conv3x3_pallas -> _winograd_call -> _kernel.  The TPU kernel
//   splits both operands into bf16 hi/lo halves and runs the 16
//   Winograd-domain products as three MXU passes (hi*hi + hi*lo + lo*hi,
//   f32 accumulation).  This kernel does the same with TF32 halves
//   ("3xTF32"): hi = x rounded to TF32 (cvt.rna: nearest, ties away from
//   zero, 10 mantissa bits), lo = the TF32 rounding of x - hi.  The dropped
//   lo*lo term and the rounding of lo each cost ~2^-22 relative, so the
//   result keeps float32-level accuracy (gate: max|y - ref| / max|ref| <
//   1e-5 against a float32 direct conv); no single-pass TF32 product
//   reaches the output.
//
// What bounds it on the H100.  Per output pixel the 16 products cost
// Ci * Co * 4 multiply-adds, 3x that in 3xTF32.  One float32 pass on the
// CUDA cores peaks at ~67 TFLOP/s, the TF32 tensor cores at 495, so three
// passes there still beat one float32 pass.  The Winograd domain would be
// 4x the input in device memory; here it never leaves the SM (V in
// registers, M in the accumulators).  What bounds this design is L2: a
// block covers only 64 tiles (the 128 accumulators a thread allow no
// more), so it re-reads the U_hi/U_lo slice of every 8-channel step (32 KB,
// three times its input patch).  Measured on an H100 SXM (700 W) at Conv_8
// (16 x 256^2, 384 -> 128 channels): the loads and the epilogue alone take
// 5.1 ms (~6.7 TB/s out of L2), loads + products 8.0 ms, loads + transform
// 7.7 ms, the whole kernel 10.7 ms; 3, 4 or 5 ring stages time the same.
// Fewer U bytes a product is the next step: blocks of a cluster sharing one
// multicast copy of each U stage.
//
// Design (one block = 8x8 output tiles (16x16 pixels) x 32 output
// channels x all 16 Winograd positions; 256 threads = two warpgroups; one
// block per SM):
// 1. Products: wgmma.mma_async m64n32k8 .tf32: A = V from registers (64
//    tiles x 8 input channels), B = U from shared memory (8 x 32, K-major).
//    Three per position: lo*hi, hi*lo, hi*hi into one float32 accumulator.
//    The wrapper passes U already split (U_hi, U_lo, exact TF32 values);
//    the kernel splits V with cvt.rna, so the MMA never sees unrounded
//    float32 (the hardware would drop its low bits).
// 2. Registers: warpgroup h owns the positions of rows a = 2h, 2h + 1
//    (8 of the 16) for all 64 tiles x 32 channels: 8 x 16 = 128 float
//    accumulators a thread.  Each thread transforms V = B^T d B only for
//    its own A-fragment elements (2 tiles x 2 channels) and only for its
//    warpgroup's two rows, straight from the input patch: V is never
//    stored and no thread repeats another's transform.  Y = A^T M A is
//    linear in M, so each warpgroup forms the partial Y of its rows in
//    registers; the halves meet through shared memory (each warpgroup
//    finishes 16 of the 32 channels) and are stored NHWC with the bias.
//    Co_blk = 32 fits the Co = 32 layers exactly; wider layers walk Co
//    blocks (the fastest grid index, so the blocks that share an input
//    patch run together and re-read it from L2).
// 3. Loads: a ring of 4 stages, each holding the 18x18 x 8-channel input
//    patch and the matching U_hi and U_lo slices, filled by cp.async
//    (16 bytes a copy; a zero-byte source fills zeros, which is SAME
//    padding and the ragged edge).  The wrapper lays U out in stage order
//    (`ops.winograd.kernel_filter_layout`), so a stage's U is one
//    contiguous 16 KB run.  Two stages are in flight while one is
//    multiplied; a stage is refilled only after the wgmma groups that read
//    it have retired (wgmma.wait_group 1 before each new group).
//    182,912 bytes of dynamic shared memory.
// 4. Ragged channels: the wrapper zero-pads Ci to a multiple of 8 (16-byte
//    copies, one k-step) and U's Co to a multiple of 32; the kernel masks
//    the Co tail and the tiles beyond H/2 x W/2 at the store.
// Shared-memory layouts keep the fragment loads free of bank conflicts:
// every pixel pair of the patch is followed by 4 floats, so that 8 tiles x
// 4 channels land in 32 banks; the partial-Y rows are padded to 136 floats.
//
// Layouts: x (B, H, W, Ci) NHWC with Ci % 8 == 0; U_hi, U_lo (Co_p/32,
// Ci/8, 16, 2, 32, 4) = [Co block][Ci slice][position k = 4a + b][input
// channels 0-3 | 4-7][output channel][4 input channels]; bias (Co,); y (B,
// H, W, Co).  H and W must be even (the Python wrapper pads).  All
// transform coefficients are 0, +-1, +-1/2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TR = 8;                    // tile rows per block (a tile = 2x2 outputs)
constexpr int TC = 8;                    // tile cols per block
constexpr int NT = TR * TC;              // 64 tiles: the wgmma's M
constexpr int CO_BLK = 32;               // output channels per block: the wgmma's N
constexpr int CI_CH = 8;                 // input channels per stage: the wgmma's K
constexpr int PR = 2 * TR + 2;           // input patch rows (with the 1-px halo)
constexpr int PC = 2 * TC + 2;           // input patch cols
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 2;        // stages in flight while one is multiplied
constexpr int THREADS = 256;             // two warpgroups
// patch: a pixel's 8 channels are contiguous, and every pixel pair is followed by
// 4 floats of padding, so that the A-fragment reads (8 tiles x 4 channels a warp)
// hit 32 distinct banks
constexpr int ROW_F = PC / 2 * 20;       // floats per patch row
constexpr int U_POS = CI_CH * CO_BLK;    // one position of U: [2][32 n][4]
constexpr int PATCH_FLOATS = PR * ROW_F;
constexpr int U_FLOATS = 16 * U_POS;
constexpr int STAGE_FLOATS = PATCH_FLOATS + 2 * U_FLOATS;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int P_LD = 4 * CO_BLK + 8;     // partial-Y floats a tile: 4 pixels x 32 channels
static_assert(PATCH_FLOATS % 4 == 0 && U_FLOATS % 4 == 0,
              "cp.async destinations and wgmma operands must stay 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory a block");
static_assert(NT * P_LD <= STAGES * STAGE_FLOATS, "the partial Y must fit the drained ring");

__device__ __forceinline__ int pix_off(int pc) { return 8 * pc + 4 * (pc >> 1); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
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

// shared-memory descriptor of one position's K-major B (no swizzle): core
// matrices of 8 output channels x 16 bytes, 128 bytes apart along N, 512 bytes
// apart along K
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__global__ void __launch_bounds__(THREADS, 1)
winograd_kernel(const float* __restrict__ x, const float* __restrict__ U_hi,
                const float* __restrict__ U_lo, const float* __restrict__ bias,
                float* __restrict__ y, int H, int W, int Ci, int Co,
                int col_blocks, int co_blocks) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int co_blk = blockIdx.x % co_blocks;
  const int sp = blockIdx.x / co_blocks;
  const int co0 = co_blk * CO_BLK;
  const int ti0 = (sp / col_blocks) * TR;
  const int tj0 = (sp % col_blocks) * TC;
  const int r0 = 2 * ti0 - 1;
  const int c0 = 2 * tj0 - 1;
  const float* xb = x + (size_t)b * H * W * Ci;
  const int n_chunks = Ci / CI_CH;

  auto load_stage = [&](int chunk) {
    float* patch = smem + (chunk % STAGES) * STAGE_FLOATS;
    float* uh = patch + PATCH_FLOATS;
    float* ul = uh + U_FLOATS;
    const int ci0 = chunk * CI_CH;
    for (int e = tid; e < PR * PC * 2; e += THREADS) {
      const int pix = e >> 1, half = e & 1;
      const int pr = pix / PC, pc = pix % PC;
      const int r = r0 + pr, c = c0 + pc;
      const bool valid = r >= 0 && r < H && c >= 0 && c < W;
      const float* src = valid ? xb + ((size_t)r * W + c) * Ci + ci0 + 4 * half : x;
      cp_async16(patch + pr * ROW_F + pix_off(pc) + 4 * half, src, valid);
    }
    const size_t u0 = ((size_t)co_blk * n_chunks + chunk) * U_FLOATS;
    for (int e = tid; e < U_FLOATS / 4; e += THREADS) {
      cp_async16(uh + 4 * e, U_hi + u0 + 4 * e, true);
      cp_async16(ul + 4 * e, U_lo + u0 + 4 * e, true);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int tg = warp & 3;               // the warp's tiles 16 tg .. +15: tile rows 2 tg, 2 tg + 1
  const int hg = warp >> 2;              // the warpgroup: position rows a = 2 hg, 2 hg + 1
  // A-fragment element i is tile 16 tg + g + 8 * (i & 1), input channel tq + 4 * (i >> 1);
  // its 4x4 input patch starts at patch row 2 * (2 tg + (i & 1)), column 2 g
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a_off[i] = 2 * (2 * tg + (i & 1)) * ROW_F + 20 * g + tq + 4 * (i >> 1);
  // row a of B^T d is d[ra] + s * d[rb]: a = 0: d0 - d2, 1: d1 + d2, 2: d2 - d1, 3: d1 - d3;
  // row a of A^T has c0 = [1, 1, 1, 0][a] in output row 0 and c1 = [0, 1, -1, -1][a] in row 1
  int ra[2], rb[2];
  float rs[2], c0a[2], c1a[2];
#pragma unroll
  for (int ar = 0; ar < 2; ++ar) {
    const int a = 2 * hg + ar;
    ra[ar] = (a == 0 ? 0 : a == 2 ? 2 : 1) * ROW_F;
    rb[ar] = (a < 2 ? 2 : a == 2 ? 1 : 3) * ROW_F;
    rs[ar] = a == 1 ? 1.f : -1.f;
    c0a[ar] = a == 3 ? 0.f : 1.f;
    c1a[ar] = a == 0 ? 0.f : a == 1 ? 1.f : -1.f;
  }

  // acc[4 ar + bb]: position (2 hg + ar, bb); element 4 n + e is tile
  // 16 tg + g + 8 (e >> 1), channel 8 n + 2 tq + (e & 1).  Set by the first
  // slice's products (scale_d = 0).
  float acc[8][16];
  uint32_t abuf[2][4][8];                // A (hi, lo) of one row's 4 positions, per row

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_chunks) load_stage(s);
    cp_async_commit();
  }

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<AHEAD - 1>();          // this thread's copies of `chunk` landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();                     // everyone's did; every group of chunk - 2 retired
    if (chunk + AHEAD < n_chunks) load_stage(chunk + AHEAD);
    cp_async_commit();

    const float* patch = smem + (chunk % STAGES) * STAGE_FLOATS;
    const uint64_t dh = smem_desc(patch + PATCH_FLOATS);
    const uint64_t dl = smem_desc(patch + PATCH_FLOATS + U_FLOATS);
    const int sd = chunk > 0;

#pragma unroll
    for (int ar = 0; ar < 2; ++ar) {
      uint32_t (&ab)[4][8] = abuf[ar];
      wgmma_wait<1>();                   // the group that read this buffer retired
      float rt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float* p = patch + a_off[i] + 8 * v + 4 * (v >> 1);
          rt[i][v] = fmaf(rs[ar], p[rb[ar]], p[ra[ar]]);
        }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* r = rt[i];
          const float v = bb == 0 ? r[0] - r[2] : bb == 1 ? r[1] + r[2]
                        : bb == 2 ? r[2] - r[1] : r[1] - r[3];
          ab[bb][i] = to_tf32(v);
          ab[bb][4 + i] = to_tf32(v - __uint_as_float(ab[bb][i]));
        }
      wgmma_fence();
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const uint64_t off = (uint64_t)((4 * (2 * hg + ar) + bb) * U_POS * 4) >> 4;
        wgmma_m64n32k8(acc[4 * ar + bb], ab[bb] + 4, dh + off, sd);  // small terms first
        wgmma_m64n32k8(acc[4 * ar + bb], ab[bb], dl + off, 1);
        wgmma_m64n32k8(acc[4 * ar + bb], ab[bb], dh + off, 1);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(acc[k][i]);
  cp_async_wait<0>();
  __syncthreads();                       // the ring is drained: reuse it for the partial Y

  // partial Y of this warpgroup's rows: o[hh][n][j][pixel] of tile 16 tg + g + 8 hh,
  // channel 8 n + 2 tq + j
  float o[2][4][2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * n + 2 * hh + j;
        float G0[4], G1[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          G0[v] = fmaf(c0a[1], acc[4 + v][e], c0a[0] * acc[v][e]);
          G1[v] = fmaf(c1a[1], acc[4 + v][e], c1a[0] * acc[v][e]);
        }
        o[hh][n][j][0] = G0[0] + G0[1] + G0[2];
        o[hh][n][j][1] = G0[1] - G0[2] - G0[3];
        o[hh][n][j][2] = G1[0] + G1[1] + G1[2];
        o[hh][n][j][3] = G1[1] - G1[2] - G1[3];
      }
  // warpgroup hg finishes channels 16 hg .. 16 hg + 15 and hands the others over
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if ((n >> 1) == hg) continue;
      const int t = 16 * tg + g + 8 * hh;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<float2*>(smem + t * P_LD + p * CO_BLK + 8 * n + 2 * tq) =
            make_float2(o[hh][n][0][p], o[hh][n][1][p]);
    }
  __syncthreads();

  const int ho = H / 2, wo = W / 2;
  const bool pairs = (Co & 1) == 0;      // float2 stores stay 8-byte aligned
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = 16 * tg + g + 8 * hh;
    const int ti = ti0 + t / TC, tj = tj0 + t % TC;
    if (ti >= ho || tj >= wo) continue;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int n = 2 * hg + nn;
      const int col = co0 + 8 * n + 2 * tq;
      if (col >= Co) continue;
      float mine[2][4];                  // o[hh][n] without a runtime register index
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int p = 0; p < 4; ++p) mine[j][p] = hg ? o[hh][2 + nn][j][p] : o[hh][nn][j][p];
      const bool has1 = col + 1 < Co;
      const float b0 = bias[col], b1 = has1 ? bias[col + 1] : 0.f;
      float* yp = y + (((size_t)b * H + 2 * ti) * W + 2 * tj) * Co + col;
      const size_t off[4] = {0, (size_t)Co, (size_t)W * Co, (size_t)W * Co + Co};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 other =
            *reinterpret_cast<const float2*>(smem + t * P_LD + p * CO_BLK + 8 * n + 2 * tq);
        const float y0 = mine[0][p] + other.x + b0, y1 = mine[1][p] + other.y + b1;
        if (pairs) {
          *reinterpret_cast<float2*>(yp + off[p]) = make_float2(y0, y1);
        } else {
          yp[off[p]] = y0;
          if (has1) yp[off[p] + 1] = y1;
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;  // device ordinals with a remembered attribute

}  // namespace

extern "C" int cia_winograd_conv3x3(const void* x, const void* U_hi, const void* U_lo,
                                    const void* bias, void* y, int B, int H, int W, int Ci,
                                    int Co, void* stream) {
  // the attribute belongs to the current device's copy of the kernel
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < MAX_DEVICES) smem_set[dev] = true;
  }
  if (Ci <= 0 || Ci % CI_CH) return (int)cudaErrorInvalidValue;
  const int ho = H / 2, wo = W / 2;
  const long long row_blocks = (ho + TR - 1) / TR;
  const long long col_blocks = (wo + TC - 1) / TC;
  const long long co_blocks = (Co + CO_BLK - 1) / CO_BLK;
  const long long nx = row_blocks * col_blocks * co_blocks;
  if (nx == 0 || B == 0) return (int)cudaGetLastError();
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nx, 1, B);
  winograd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)U_hi, (const float*)U_lo, (const float*)bias, (float*)y,
      H, W, Ci, Co, (int)col_blocks, (int)co_blocks);
  return (int)cudaGetLastError();
}
