// y = x W^T + b for the blocks' linears of a ViT (Cellpose-SAM's qkv, proj,
// lin1 and lin2), 3xTF32 on the tensor cores with wgmma, fed by TMA.
//
// Replaces: nothing of the JAX package, which has no ViT.  The alternative on
// the card is cuBLAS's float32 SGEMM on the CUDA cores, whose ceiling is the
// H100's ~67 TFLOP/s of float32 FMA.
//
// Bound: operations.  A product of M x K by K x N at float32 accuracy runs as
// three TF32 products (lo*hi + hi*lo + hi*hi, as csrc/winograd_conv3x3.cu and
// csrc/vit_attention.cu), 3 x 2MNK TF32 FLOPs at the 495 TFLOP/s of the dense
// TF32 peak; the bytes (x and y once, W from L2) are far below it at
// Cellpose-SAM's M = 102,400 rows.  What the design does about it:
//
// 1. Loads: one thread issues TMA (cp.async.bulk.tensor) for a stage's x
//    (128 rows x 32 k) and W (128 columns x 32 k) tiles, both K-major with
//    the 128-byte swizzle, into a ring of 4 stages behind mbarriers, so the
//    tensor cores never wait on an address computation or a load.
// 2. The split of W: three warps of the producer warpgroup round each landed
//    W tile to TF32 in place (hi, cvt.rna) and write the TF32 rounding of
//    the remainder (lo) beside it, once a stage, so that the two consumer
//    warpgroups read B for all their products from shared memory.  No split
//    copy of a weight lives in device memory.
// 3. The split of x: each consumer warp takes its 16 rows of a k step from
//    the swizzled tile with one ldmatrix.x4 (32-bit words as pairs of b16:
//    exactly the m64nNk8 TF32 A fragment) and splits them in registers; wgmma
//    takes A from registers.
// 4. Products: two consumer warpgroups of 64 rows each run wgmma m64n128k8,
//    a stage's 8 small products (lo*hi, hi*lo) first, then its 4 hi*hi.
// 5. Accuracy: the tensor cores' float32 accumulation drops the low bits of
//    every sum (csrc/vit_attention.cu measured ~1e-5 of the output after 384
//    chained products), and a K = 4,096 row would chain 1,536 of them.  So a
//    stage's 12 products go into accumulators of their own (scale-d 0 on the
//    first) and are added to the tile's float32 sum with ordinary FADDs once
//    a stage: at most 12 products are ever chained in the tensor cores, and
//    with the small ones first only the 4 hi*hi sums drop bits at the scale
//    of the result.
// 6. Grid: persistent, one block an SM, walking the output tiles with the
//    column tile fastest, so that the blocks in flight share a few row blocks
//    of x and all of W stays in the 50 MB L2.  The ring runs on across tiles:
//    the next tile's loads overlap this tile's epilogue (bias add, float32
//    store straight from the accumulators).
//
// Measured on an H100 SXM at its 700 W limit, M = 102,400: ~95 TFLOP/s of
// float32 work at the four shapes, ~59% of the 3xTF32 bound, 1.9x cuBLAS
// float32, within ~0.3x of cuBLAS's error against float64.  The card runs at
// its power limit (SM clock ~1.7 GHz): the consumers alone reach ~94% of the
// tensor cores' cycles, the loads and the W split alone draw ~540 W, and
// together they share the 700 W.
//
// Layouts: x (M, K), W (N, K) (nn.Linear's), bias (N) or none, y (M, N); all
// float32, contiguous, 16-byte aligned; M a multiple of 128, N of 128, K of
// 32.  Block: 384 threads; warpgroup 0 the producer (warp 0 TMA, warps 1-3 the
// W split; setmaxnreg 40), warpgroups 1 and 2 the consumers (setmaxnreg 232).
// Shared memory a stage: x 16 KB, W hi 16 KB (TMA lands W here), W lo 16 KB,
// each 1024-byte aligned: element (r, k) of a tile at byte 128 r + 16 ((k / 4)
// ^ (r % 8)) + 4 (k % 4).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;                   // rows of x a tile: two consumer warpgroups of 64
constexpr int BN = 128;                   // columns of y a tile (rows of W)
constexpr int BK = 32;                    // k a stage: one 128-byte swizzle row of float32
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int SPLITTERS = 96;             // warps 1-3
constexpr int CONSUMERS = 256;            // warpgroups 1-2
constexpr int TILE_BYTES = BM * BK * 4;   // 16 KB: an x tile, and a W tile (BN = BM)
constexpr int STAGE_BYTES = 3 * TILE_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
static_assert(BN == BM, "x and W tiles share TILE_BYTES");
static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// a box of the 2-D tensor map at (c0 along k, c1 along rows) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// shared-memory descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (+)= a * B: m64n128k8, TF32 operands, float32 accumulators; A from registers
// (the m16n8k8 A fragment of this warp's 16 rows), B K-major from shared memory;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1)
vit_linear_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle repeats every 1024 bytes
  uint8_t* const sm = smem_raw + (base - raw);
  // barriers: loaded[s] (TMA bytes), ready[s] (W split), empty[s] (consumers done)
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto loaded = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(ready(s), SPLITTERS / 32);       // one arrival a warp
      mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int col_tiles = N / BN, tiles = (M / BM) * col_tiles, kblocks = K / BK;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {                                   // TMA
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / col_tiles) * BM, n0 = (tile % col_tiles) * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(loaded(s), 2 * TILE_BYTES);
          const uint32_t st = base + s * STAGE_BYTES;
          tma_load(st, &tx, kb * BK, m0, loaded(s));
          tma_load(st + TILE_BYTES, &tw, kb * BK, n0, loaded(s));
        }
      }
    } else if (tid >= 32) {                           // the W split
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(loaded(s), (it / STAGES) & 1);
          float4* hi = reinterpret_cast<float4*>(sm + s * STAGE_BYTES + TILE_BYTES);
          float4* lo = hi + TILE_BYTES / 16;
          for (int e = tid - 32; e < TILE_BYTES / 16; e += SPLITTERS) {
            const float4 w = hi[e];
            float4 h, l;
            h.x = __uint_as_float(to_tf32(w.x));
            h.y = __uint_as_float(to_tf32(w.y));
            h.z = __uint_as_float(to_tf32(w.z));
            h.w = __uint_as_float(to_tf32(w.w));
            l.x = __uint_as_float(to_tf32(w.x - h.x));
            l.y = __uint_as_float(to_tf32(w.y - h.y));
            l.z = __uint_as_float(to_tf32(w.z - h.z));
            l.w = __uint_as_float(to_tf32(w.w - h.w));
            hi[e] = h;
            lo[e] = l;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
          __syncwarp();
          if ((tid & 31) == 0) mbar_arrive(ready(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = tid - 128, cwg = c >> 7, warp = (c >> 5) & 3, lane = c & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4: lane L gives row L % 8 of matrix L / 8; matrices (rows 0-7 | 8-15 of the
  // warp's 16) x (k 0-3 | 4-7 of the step): registers a0..a3 of the TF32 A fragment
  const int lrow = 64 * cwg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lhalf = lane >> 4, lswz = lane & 7;
  const int row = 64 * cwg + 16 * warp + g;        // this thread's rows: row, row + 8

  float acc[64], sum[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / col_tiles) * BM, n0 = (tile % col_tiles) * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      mbar_wait(loaded(s), ph);
      mbar_wait(ready(s), ph);
      const uint32_t xs = base + s * STAGE_BYTES;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t r[4];
        ldmatrix_x4(r, xs + lrow * 128 + (((2 * ks + lhalf) ^ lswz) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __uint_as_float(r[i]);
          ahi[ks][i] = to_tf32(v);
          alo[ks][i] = to_tf32(v - __uint_as_float(ahi[ks][i]));
        }
      }
      const uint64_t dh = smem_desc(xs + TILE_BYTES), dl = smem_desc(xs + 2 * TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {                // the small products first
        wgmma_m64n128k8(acc, alo[ks], dh + 2 * ks, ks > 0);
        wgmma_m64n128k8(acc, ahi[ks], dl + 2 * ks, 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_m64n128k8(acc, ahi[ks], dh + 2 * ks, 1);
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty(s));                // the warp's products are done
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        fence_operand(acc[i]);
        sum[i] += acc[i];
      }
    }
    // epilogue: sum[4 j + e] is row row + 8 (e / 2), column 8 j + 2 t + e % 2
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(y + (size_t)(m0 + row + 8 * r) * N + col) =
            make_float2(sum[4 * j + 2 * r] + b.x, sum[4 * j + 2 * r + 1] + b.y);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, K) float32 matrix as boxes of 32 k x box_rows rows, 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;  // device ordinals with a remembered attribute

}  // namespace

// y (M, N) = x (M, K) W^T + bias for W (N, K) and bias (N) or null; float32,
// contiguous, 16-byte aligned; M a multiple of 128, N of 128, K of 32
extern "C" int cia_vit_linear(const void* x, const void* w, const void* bias, void* y, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK) return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(vit_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K, BM) || !tensor_map(&tw, w, N, K, BN))
    return (int)cudaErrorInvalidValue;
  const int tiles = (M / BM) * (N / BN);
  const int grid = tiles < sms[dev] ? tiles : sms[dev];
  vit_linear_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tx, tw, (const float*)bias, (float*)y, M, N, K);
  return (int)cudaGetLastError();
}
