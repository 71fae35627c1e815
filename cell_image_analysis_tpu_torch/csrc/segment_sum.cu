// Segment sums of int64 data: out[seg[p], f] += data[p, f].
//
// Replaces: cell_image_analysis_tpu/ops/pallas/segsum.py,
//   segment_sums_pallas -> _kernel (one-hot (BLK, n_seg) MXU matmuls,
//   float32 accumulation into a revisited output block).
//
// What bounds it on the H100: on the main path it reduces the run-moment
// table of stage A (16 frames x 1024 rows x 32 run slots x 6 moments,
// int64 = 25 MB), so it reads each input byte once and is bound by device
// memory and atomic throughput; at this size a launch is microseconds.
//
// Design: a grid-stride loop, one thread per (row, feature) element, with
// `atomicAdd` on unsigned long long.  Integer addition is associative, so
// the result is exact and the same in every run whatever order the atomics
// land in (float atomics would not be).  Rows whose segment is out of
// [0, n_seg) are dropped, and zero values are skipped: empty run slots
// carry all-zero moments, which keeps the atomics to real runs.  The
// caller zero-fills `out`.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void segment_sum_kernel(const int* __restrict__ seg,
                                   const long long* __restrict__ data,
                                   unsigned long long* __restrict__ out,
                                   long long P, int F, int n_seg) {
  const long long total = P * F;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long p = e / F;
    const int f = (int)(e - p * F);
    const int s = seg[p];
    if (s < 0 || s >= n_seg) continue;
    const long long v = data[e];
    if (v != 0) atomicAdd(out + (long long)s * F + f, (unsigned long long)v);
  }
}

}  // namespace

extern "C" int cia_segment_sum_i64(const void* seg, const void* data, void* out,
                                   long long P, int F, int n_seg, void* stream) {
  const long long total = P * F;
  if (total <= 0) return (int)cudaGetLastError();
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  segment_sum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)seg, (const long long*)data, (unsigned long long*)out, P, F, n_seg);
  return (int)cudaGetLastError();
}
