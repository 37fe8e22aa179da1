// Row add, in place: plane[idx[j]] += upd[j] for an [R, W] plane of int32
// (wrapping add) or f32, with unique idx. Rows with idx outside [0, R) are
// dropped.
//
// Replaces the TPU kernel `_scatter_add_kernel` (K3, meepoembedding_tpu/
// table/pallas_ops.py:187, body :124-184, entry `row_scatter_add` :253),
// which pipelined one row DMA in and one out per index through two VMEM
// slabs. K3 clipped idx >= R onto row R - 1 (:130, :138); its callers mean
// "drop" (`mode="drop"`, xla_ops.py:411-412), and so does this kernel. On
// the training path it carries the bucket-plane adds: the rowwise
// accumulator (f32) and, when a policy keeps scores, freq (int32). Those
// planes are [nb, 128]; the callers pass the flat [nb * 128, 1] view with
// idx = slot, so each add is one element.
//
// Bound: device memory. The least traffic is the indices (4n bytes), the
// updates read once, the touched elements read once and written once
// (3 * n * W * 4 bytes). One element per index (W = 1) makes every access a
// scattered 4-byte load or store, each in a 32-byte sector of its own, so
// the device moves more than the bytes counted.
//
// Design: one thread per 16-byte vector of a row (or the widest access the
// row width and alignment allow, down to one element), grid-stride, 64-bit
// offsets. Indices are unique, so no two threads touch one element and no
// atomics are needed; the result is the same bits on every launch. W = 1
// skips the division of the element index by the row width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

long long blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return b > kMaxBlocks ? kMaxBlocks : b;
}

// one 4-byte lane: f32 add, or int32 add modulo 2^32 (unsigned, no UB)
template <bool kFloat>
__device__ __forceinline__ uint32_t add4(uint32_t a, uint32_t b) {
  if (kFloat) return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  return a + b;
}

template <bool kFloat>
__device__ __forceinline__ uint32_t add_vec(uint32_t a, uint32_t b) {
  return add4<kFloat>(a, b);
}
template <bool kFloat>
__device__ __forceinline__ uint2 add_vec(uint2 a, uint2 b) {
  return make_uint2(add4<kFloat>(a.x, b.x), add4<kFloat>(a.y, b.y));
}
template <bool kFloat>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  return make_uint4(add4<kFloat>(a.x, b.x), add4<kFloat>(a.y, b.y),
                    add4<kFloat>(a.z, b.z), add4<kFloat>(a.w, b.w));
}

template <typename V, bool kFloat>
__global__ void row_add_kernel(V* __restrict__ plane,
                               const int32_t* __restrict__ idx,
                               const V* __restrict__ upd, long long n,
                               long long rows, int vecs_per_row) {
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    long long j = e, c = 0;
    if (vecs_per_row != 1) {
      j = e / vecs_per_row;
      c = e - j * vecs_per_row;
    }
    const long long r = __ldg(idx + j);
    if (r < 0 || r >= rows) continue;
    V* dst = plane + r * vecs_per_row + c;
    *dst = add_vec<kFloat>(*dst, upd[e]);
  }
}

template <typename V, bool kFloat>
void launch(void* plane, const void* idx, const void* upd, long long n,
            long long rows, long long row_bytes, cudaStream_t s) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  row_add_kernel<V, kFloat><<<(unsigned)blocks_for(n * vpr), kThreads, 0, s>>>(
      (V*)plane, (const int32_t*)idx, (const V*)upd, n, rows, vpr);
}

template <bool kFloat>
void dispatch(void* plane, const void* idx, const void* upd, long long n,
              long long rows, long long row_bytes, int vec, cudaStream_t s) {
  switch (vec) {
    case 16: launch<uint4, kFloat>(plane, idx, upd, n, rows, row_bytes, s); break;
    case 8: launch<uint2, kFloat>(plane, idx, upd, n, rows, row_bytes, s); break;
    default: launch<uint32_t, kFloat>(plane, idx, upd, n, rows, row_bytes, s); break;
  }
}

}  // namespace

// is_float: 1 for an f32 plane, 0 for int32.
extern "C" int meepo_row_scatter_add(void* plane, const void* idx,
                                     const void* upd, long long n,
                                     long long rows, long long width,
                                     int is_float, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = width * 4;
  const uintptr_t addr = (uintptr_t)plane | (uintptr_t)upd;
  int vec = 16;
  while (vec > 4 && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  if (is_float) {
    dispatch<true>(plane, idx, upd, n, rows, row_bytes, vec, s);
  } else {
    dispatch<false>(plane, idx, upd, n, rows, row_bytes, vec, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
