// Connected components of boolean masks: raw min-index labels.
//
// Replaces: cell_image_analysis_tpu/ops/pallas/cc_kernel.py,
//   cc_min_labels_pallas -> _make_kernel (the whole label image resident in
//   VMEM, min-label propagation sweeps repeated until a change flag clears).
//
// Contract: mask (B, H, W) uint8 (0/1), connectivity 1 (4-neighbourhood) or
// 2 (8-neighbourhood) -> out (B, H, W) int32, where each foreground pixel
// holds its component's smallest frame-local linear index + 1 and the
// background holds 0.  `parent` (B, H, W) int32 is scratch.
//
// What bounds it on the H100: sweeps need as many passes as the longest
// geodesic in a component (~170 on the bench's 1024^2 masks), each a full
// read and write of the label image.  A 16 x 1024^2 batch of labels is
// 64 MB, beyond the 50 MB L2, so that would be ~170 x 128 MB of device
// memory traffic.  Union-find needs three passes whatever the shape.
//
// Design: union-find in global memory, three launches, no host loop.
//   1. init: parent[i] = i (frame-local index) on every pixel;
//   2. union: each foreground pixel joins its foreground neighbours that come
//      earlier in raster order (left and up; also up-left and up-right at
//      connectivity 2).  Roots are found by following parents, halving the
//      path with atomicMin as it goes, and linked with atomicMin, always the
//      larger root under the smaller; a link whose target stopped being a
//      root meanwhile retries from what it found there.
//   3. flatten: out[i] = root(i) + 1 on foreground, 0 on background.
// Every write is an atomicMin of a pointer to a node of the same component,
// so a parent only ever moves to a smaller index of its own component and a
// root's index is the smallest of its tree.  When the unions are done each
// component is one tree, and its root is the component minimum: the same
// fixpoint as the TPU kernel's, whatever order the threads ran in.
// Parent indices are frame-local int32; addresses add the frame's base as a
// 64-bit offset, so B*H*W may exceed 2^31 while H*W may not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__global__ void cc_init(int* __restrict__ parent, long long total, int hw) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    parent[i] = (int)(i % hw);
}

__global__ void cc_union(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                         long long total, int h, int w, int conn) {
  const long long hw = (long long)h * w;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (!mask[i]) continue;
    const long long base = (i / hw) * hw;
    const int k = (int)(i - base);
    const int r = k / w, c = k - r * w;
    const uint8_t* m = mask + base;
    int* p = parent + base;
    if (c > 0 && m[k - 1]) unite(p, k, k - 1);
    if (r > 0) {
      const int up = k - w;
      if (m[up]) unite(p, k, up);
      if (conn == 2) {
        if (c > 0 && m[up - 1]) unite(p, k, up - 1);
        if (c + 1 < w && m[up + 1]) unite(p, k, up + 1);
      }
    }
  }
}

__global__ void cc_flatten(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                           int* __restrict__ out, long long total, int hw) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (!mask[i]) {
      out[i] = 0;
      continue;
    }
    const long long base = (i / hw) * hw;
    out[i] = find_root(parent + base, (int)(i - base)) + 1;
  }
}

}  // namespace

extern "C" int cia_cc_min_labels(const void* mask, void* parent, void* out, int B, int h,
                                 int w, int conn, void* stream) {
  const long long total = (long long)B * h * w;
  if (total <= 0) return (int)cudaGetLastError();
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  int* p = (int*)parent;
  cc_init<<<(unsigned)blocks, THREADS, 0, s>>>(p, total, h * w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_union<<<(unsigned)blocks, THREADS, 0, s>>>(m, p, total, h, w, conn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_flatten<<<(unsigned)blocks, THREADS, 0, s>>>(m, p, (int*)out, total, h * w);
  return (int)cudaGetLastError();
}
