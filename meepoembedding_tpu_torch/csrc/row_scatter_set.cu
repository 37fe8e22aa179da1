// Row set, in place: plane[idx[j]] = upd[j] for an [R, W] plane of 2- or
// 4-byte elements. Rows with idx outside [0, R) are dropped; the rows left
// must be unique.
//
// Replaces two TPU kernels with one: `_scatter_set_kernel` (K4,
// meepoembedding_tpu/table/pallas_ops.py:200, entry `row_scatter_set` :274)
// and `_kernel_set` (K5, meepoembedding_tpu/table/stream_merge.py:224,
// entry `stream_merge_set` :496). Both set the lanes of 128-lane rows under
// a mask: K4 with unique rows, K5 with duplicate rows whose masks are
// disjoint, merged on the MXU block by block. That masked set is this
// kernel on the plane's flat [R * W, 1] view, with one index per masked
// element (row * W + lane): the (row, lane) pairs are unique, so no two
// threads write one element and no combine pass is needed. The callers do
// exactly that for the one-hot bucket-plane writes (one lane per row), and
// set whole rows of the row-major values plane. One difference from K4 is
// deliberate: K4 clipped idx >= R onto row R - 1, while K5 and every caller
// drop it; this kernel drops it.
//
// Bound: device memory. The least traffic is the indices (4n bytes), the
// updates read once and the same bytes written once (2 * n * W * elem). At
// the restore path's shapes (65,536 rows per batch) that is 0.79 MB for a
// bucket-plane write (W = 1, int32) and 17 MB for a values write (W = 32,
// f32). The bucket-plane writes are scattered 4-byte stores, each in a
// 32-byte sector of its own, so the device moves more than the bytes counted.
//
// Design: one thread per 16-byte vector of a row (or the widest access the
// row width and alignment allow, down to one element), grid-stride. The
// element type is only a bit width (the kernel copies bits), so one template
// covers int32, f32 and bf16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct alignas(16) Vec16 { uint4 v; };
struct alignas(8) Vec8 { uint2 v; };

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

long long blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return b > kMaxBlocks ? kMaxBlocks : b;
}

template <typename V>
__global__ void row_set_kernel(V* __restrict__ plane,
                               const int32_t* __restrict__ idx,
                               const V* __restrict__ upd, long long n,
                               long long rows, int vecs_per_row) {
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long j = e / vecs_per_row;
    const long long r = __ldg(idx + j);
    if (r < 0 || r >= rows) continue;
    plane[r * vecs_per_row + (e - j * vecs_per_row)] = upd[e];
  }
}

template <typename V>
void launch_rows(void* plane, const void* idx, const void* upd, long long n,
                 long long rows, long long row_bytes, cudaStream_t s) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  row_set_kernel<V><<<(unsigned)blocks_for(n * vpr), kThreads, 0, s>>>(
      (V*)plane, (const int32_t*)idx, (const V*)upd, n, rows, vpr);
}

}  // namespace

// elem_bytes is 2 or 4.
extern "C" int meepo_row_scatter_set(void* plane, const void* idx,
                                     const void* upd, long long n,
                                     long long rows, long long width,
                                     int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = width * elem_bytes;
  const uintptr_t addr = (uintptr_t)plane | (uintptr_t)upd;
  int vec = 16;
  while (vec > 2 && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  switch (vec) {
    case 16: launch_rows<Vec16>(plane, idx, upd, n, rows, row_bytes, s); break;
    case 8: launch_rows<Vec8>(plane, idx, upd, n, rows, row_bytes, s); break;
    case 4: launch_rows<uint32_t>(plane, idx, upd, n, rows, row_bytes, s); break;
    default: launch_rows<uint16_t>(plane, idx, upd, n, rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
