// SAME 3x3 stride-1 convolution + bias by Winograd F(2x2, 3x3), true float32.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/winograd.py,
//   winograd_conv3x3_pallas -> _winograd_call -> _kernel (the TPU kernel
//   computes the 16 Winograd products as 3-pass bf16 hi/lo MXU matmuls).
//
// What bounds it on the H100: the 16 element-wise products, accumulated
// over Ci, are float32 FMAs on the CUDA cores (no tensor cores: the port
// needs float32 numerics, and TF32 keeps only 10 mantissa bits).  The
// U-Net's wide layers (Ci*Co up to 384*128 and 256*256) make it
// compute-bound; the thin ones (Ci = 1, Co = 32 at 1024^2) are bound by
// reading x and writing y.  The Winograd domain would be 4x the input in
// device memory (8 GB for the 16 x 1024^2 x 32 level-0 activation).
//
// Design: one block computes 4x8 output tiles (8x16 pixels) for 64 output
// channels and never writes the Winograd domain to device memory.  Per
// chunk of 4 input channels it stages the 10x18 input patch (zero halo =
// SAME padding) and the matching slice of U = G W G^T in shared memory,
// transforms the patch to V = B^T d B there, and each of 256 threads
// accumulates 16 products for 2 tiles x 4 channels in registers.  The
// inverse transform Y = A^T M A and the bias run in registers before the
// NHWC store.  All transform coefficients are 0, +-1, +-1/2.
//
// Layouts: x (B, H, W, Ci) NHWC, U (16, Ci, Co) with k = 4a + b,
// bias (Co,), y (B, H, W, Co).  H and W must be even (checked by the
// Python wrapper).

#include <cuda_runtime.h>

namespace {

constexpr int TR = 4;            // tile rows per block (a tile = 2x2 outputs)
constexpr int TC = 8;            // tile cols per block
constexpr int NT = TR * TC;      // tiles per block
constexpr int CO_BLK = 64;       // output channels per block
constexpr int CI_BLK = 4;        // input channels per shared-memory chunk
constexpr int PR = 2 * TR + 2;   // input patch rows (with the 1-px halo)
constexpr int PC = 2 * TC + 2;   // input patch cols
constexpr int THREADS = 256;     // 16 tile pairs x 16 channel quads

__global__ void __launch_bounds__(THREADS)
winograd_kernel(const float* __restrict__ x, const float* __restrict__ U,
                const float* __restrict__ bias, float* __restrict__ y,
                int H, int W, int Ci, int Co, int col_blocks) {
  __shared__ float patch[PR][PC][CI_BLK];
  __shared__ __align__(16) float V[16][CI_BLK][NT];
  __shared__ __align__(16) float Us[16][CI_BLK][CO_BLK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO_BLK;
  const int ti0 = (blockIdx.x / col_blocks) * TR;
  const int tj0 = (blockIdx.x % col_blocks) * TC;
  const int r0 = 2 * ti0 - 1;
  const int c0 = 2 * tj0 - 1;
  const int cq = tid % 16;       // channels co0 + 4*cq .. +3
  const int tp = tid / 16;       // tiles 2*tp, 2*tp + 1

  float acc[2][4][16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[i][j][k] = 0.f;

  const float* xb = x + (size_t)b * H * W * Ci;
  for (int ci0 = 0; ci0 < Ci; ci0 += CI_BLK) {
    for (int e = tid; e < PR * PC * CI_BLK; e += THREADS) {
      const int c = e % CI_BLK;
      const int pc = (e / CI_BLK) % PC;
      const int pr = e / (CI_BLK * PC);
      const int r = r0 + pr, cc = c0 + pc, ci = ci0 + c;
      float v = 0.f;
      if (r >= 0 && r < H && cc >= 0 && cc < W && ci < Ci)
        v = xb[((size_t)r * W + cc) * Ci + ci];
      patch[pr][pc][c] = v;
    }
    for (int e = tid; e < 16 * CI_BLK * CO_BLK; e += THREADS) {
      const int co = e % CO_BLK;
      const int c = (e / CO_BLK) % CI_BLK;
      const int k = e / (CO_BLK * CI_BLK);
      const int ci = ci0 + c, cog = co0 + co;
      Us[k][c][co] = (ci < Ci && cog < Co) ? U[((size_t)k * Ci + ci) * Co + cog] : 0.f;
    }
    __syncthreads();

    if (tid < NT * CI_BLK) {     // input transform V = B^T d B
      const int t = tid % NT, c = tid / NT;
      const int tr = t / TC, tc = t % TC;
      float d[4][4], rt[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) d[u][v] = patch[2 * tr + u][2 * tc + v][c];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        rt[0][v] = d[0][v] - d[2][v];
        rt[1][v] = d[1][v] + d[2][v];
        rt[2][v] = d[2][v] - d[1][v];
        rt[3][v] = d[1][v] - d[3][v];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        V[4 * a + 0][c][t] = rt[a][0] - rt[a][2];
        V[4 * a + 1][c][t] = rt[a][1] + rt[a][2];
        V[4 * a + 2][c][t] = rt[a][2] - rt[a][1];
        V[4 * a + 3][c][t] = rt[a][1] - rt[a][3];
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CI_BLK; ++c) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(&V[k][c][2 * tp]);
        const float4 u = *reinterpret_cast<const float4*>(&Us[k][c][4 * cq]);
        acc[0][0][k] = fmaf(v.x, u.x, acc[0][0][k]);
        acc[0][1][k] = fmaf(v.x, u.y, acc[0][1][k]);
        acc[0][2][k] = fmaf(v.x, u.z, acc[0][2][k]);
        acc[0][3][k] = fmaf(v.x, u.w, acc[0][3][k]);
        acc[1][0][k] = fmaf(v.y, u.x, acc[1][0][k]);
        acc[1][1][k] = fmaf(v.y, u.y, acc[1][1][k]);
        acc[1][2][k] = fmaf(v.y, u.z, acc[1][2][k]);
        acc[1][3][k] = fmaf(v.y, u.w, acc[1][3][k]);
      }
    }
    __syncthreads();             // the next chunk overwrites patch, V, Us
  }

  const int ho = H / 2, wo = W / 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * tp + i;
    const int ti = ti0 + t / TC, tj = tj0 + t % TC;
    if (ti >= ho || tj >= wo) continue;
    float* yb = y + (((size_t)b * H + 2 * ti) * W + 2 * tj) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * cq + j;
      if (co >= Co) continue;
      const float* m = acc[i][j];
      // inverse transform Y = A^T M A, A^T = [[1,1,1,0],[0,1,-1,-1]]
      float g[8];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        g[v] = m[v] + m[4 + v] + m[8 + v];
        g[4 + v] = m[4 + v] - m[8 + v] - m[12 + v];
      }
      const float bb = bias[co];
      yb[co] = g[0] + g[1] + g[2] + bb;
      yb[Co + co] = g[1] - g[2] - g[3] + bb;
      yb[(size_t)W * Co + co] = g[4] + g[5] + g[6] + bb;
      yb[(size_t)W * Co + Co + co] = g[5] - g[6] - g[7] + bb;
    }
  }
}

}  // namespace

extern "C" int cia_winograd_conv3x3(const void* x, const void* U, const void* bias,
                                    void* y, int B, int H, int W, int Ci, int Co,
                                    void* stream) {
  const int ho = H / 2, wo = W / 2;
  const int row_blocks = (ho + TR - 1) / TR;
  const int col_blocks = (wo + TC - 1) / TC;
  dim3 grid(row_blocks * col_blocks, (Co + CO_BLK - 1) / CO_BLK, B);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return (int)cudaGetLastError();
  winograd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)U, (const float*)bias, (float*)y, H, W, Ci, Co,
      col_blocks);
  return (int)cudaGetLastError();
}
