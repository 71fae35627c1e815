// Cellpose's flow following (dynamics.follow_flows / steps2D_interp) on the card.
//
// Replaces no TPU kernel: the JAX package has no Cellpose backend.  It was
// added because the plain version (ops/flows.follow_flows_plain) launches a
// grid_sample and four small operations for each of the 200 steps, and the
// steps of one point depend on each other.
//
// What it computes, for B frames of H x W (NCHW float32 dP (B, 2, H, W),
// cellprob (B, H, W)):
//   field = dP * (cellprob > threshold) / 5   (IEEE division, as numpy's)
//   a pixel moves where |field_y| > 1e-3 and its frame has at least 5 such
//   pixels; every other pixel keeps its own (y, x);
//   a moving pixel's position and the field are normalised by L - 1 a side
//   (field * (2 / (L - 1)), position * (1 / (L - 1)) then 2p - 1: PyTorch's
//   division by a scalar on the card multiplies by its float reciprocal),
//   and for `niter` steps p = clamp(p + bilinear(field, p), -1, 1), the
//   sample being grid_sample's (align_corners=False, zeros padding: the
//   source index ((p + 1) * L - 1) / 2, corner weights as GridSampler.cuh
//   forms them); the normalisation is then undone.
//
// Bound: the least work is reading dP and cellprob once and writing every
// pixel's final position once (bytes at the HBM peak).  The real bound is
// latency: each step of a point waits for its four corner loads, 200 steps
// in a chain.  The design keeps a point's whole chain in one thread (no
// launch a step), computes the field of a corner from dP and cellprob where
// it is read (no field buffer), and has enough threads in flight (one a
// pixel; the still pixels leave at once) to hide the loads' latency.  A
// frame's field is 12 MB of reads, so the points of a frame sample from L2.
//
// Entry: cia_follow_flows (plain C interface, ctypes).  Two kernels on the
// given stream: follow_flows_count_kernel (each frame's moving pixels) and
// follow_flows_kernel.  Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinPoints = 5;

__device__ __forceinline__ float field_at(const float* __restrict__ d,
                                          const float* __restrict__ cp, long long q,
                                          float threshold) {
  const float m = cp[q] > threshold ? 1.0f : 0.0f;
  return (d[q] * m) / 5.0f;
}

__global__ void follow_flows_count_kernel(const float* __restrict__ dP,
                                          const float* __restrict__ cellprob,
                                          int* __restrict__ n_moving, int H, int W,
                                          float threshold) {
  const long long hw = (long long)H * W;
  const int b = blockIdx.y;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int moving = 0;
  if (q < hw) {
    const float fy = field_at(dP + (long long)b * 2 * hw, cellprob + (long long)b * hw, q,
                              threshold);
    moving = fabsf(fy) > 1e-3f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, moving);
  if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(n_moving + b, __popc(ballot));
}

__global__ void follow_flows_kernel(const float* __restrict__ dP,
                                    const float* __restrict__ cellprob,
                                    const int* __restrict__ n_moving, float* __restrict__ out,
                                    int H, int W, int niter, float threshold) {
  const long long hw = (long long)H * W;
  const int b = blockIdx.y;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= hw) return;
  const float* dy = dP + (long long)b * 2 * hw;
  const float* dx = dy + hw;
  const float* cp = cellprob + (long long)b * hw;
  float* oy = out + (long long)b * 2 * hw;
  float* ox = oy + hw;
  const int y = (int)(q / W), x = (int)(q % W);
  const float fy0 = field_at(dy, cp, q, threshold);
  if (!(fabsf(fy0) > 1e-3f) || n_moving[b] < kMinPoints) {
    oy[q] = (float)y;
    ox[q] = (float)x;
    return;
  }
  const float shape_x = (float)(W - 1), shape_y = (float)(H - 1);
  const float sx = (float)(2.0 / (double)(W - 1)), sy = (float)(2.0 / (double)(H - 1));
  const float inv_x = 1.0f / shape_x, inv_y = 1.0f / shape_y;
  float px = (float)x * inv_x;
  float py = (float)y * inv_y;
  px = px * 2.0f - 1.0f;
  py = py * 2.0f - 1.0f;
  const float fW = (float)W, fH = (float)H;
  for (int t = 0; t < niter; ++t) {
    const float ix = ((px + 1.0f) * fW - 1.0f) / 2.0f;
    const float iy = ((py + 1.0f) * fH - 1.0f) / 2.0f;
    const float fx_nw = floorf(ix), fy_nw = floorf(iy);
    const int ix_nw = (int)fx_nw, iy_nw = (int)fy_nw;
    const float ix_se = fx_nw + 1.0f, iy_se = fy_nw + 1.0f;
    const float w_nw = (ix_se - ix) * (iy_se - iy);
    const float w_ne = (ix - fx_nw) * (iy_se - iy);
    const float w_sw = (ix_se - ix) * (iy - fy_nw);
    const float w_se = (ix - fx_nw) * (iy - fy_nw);
    float gx = 0.0f, gy = 0.0f;
    const int cx[4] = {ix_nw, ix_nw + 1, ix_nw, ix_nw + 1};
    const int cy[4] = {iy_nw, iy_nw, iy_nw + 1, iy_nw + 1};
    const float wt[4] = {w_nw, w_ne, w_sw, w_se};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (cx[c] >= 0 && cx[c] < W && cy[c] >= 0 && cy[c] < H) {
        const long long r = (long long)cy[c] * W + cx[c];
        gx += (field_at(dx, cp, r, threshold) * sx) * wt[c];
        gy += (field_at(dy, cp, r, threshold) * sy) * wt[c];
      }
    }
    px = fminf(fmaxf(px + gx, -1.0f), 1.0f);
    py = fminf(fmaxf(py + gy, -1.0f), 1.0f);
  }
  ox[q] = ((px + 1.0f) * 0.5f) * shape_x;
  oy[q] = ((py + 1.0f) * 0.5f) * shape_y;
}

}  // namespace

extern "C" int cia_follow_flows(const void* dP, const void* cellprob, void* out, void* n_moving,
                                int B, int H, int W, int niter, float threshold, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)B);
  cudaMemsetAsync(n_moving, 0, sizeof(int) * (size_t)B, s);
  follow_flows_count_kernel<<<grid, kThreads, 0, s>>>((const float*)dP, (const float*)cellprob,
                                                      (int*)n_moving, H, W, threshold);
  follow_flows_kernel<<<grid, kThreads, 0, s>>>((const float*)dP, (const float*)cellprob,
                                                (const int*)n_moving, (float*)out, H, W, niter,
                                                threshold);
  return (int)cudaGetLastError();
}
