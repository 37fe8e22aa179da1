// Row set into up to kMaxPlanes planes that share one index vector, in place:
// plane_p[idx[j]] = upd_p[j] for [R, W] planes of one row width and one
// element size (2 or 4 bytes). Each plane's value is an [n, W] tensor or a
// scalar, whose bits come in the argument struct, so nothing is
// materialised for it. Rows with idx outside [0, R) are dropped; the rows
// left must be unique.
//
// Replaces two TPU kernels with one: `_scatter_set_kernel` (K4,
// meepoembedding_tpu/table/pallas_ops.py:200, entry `row_scatter_set` :274)
// and `_kernel_set` (K5, meepoembedding_tpu/table/stream_merge.py:224,
// entry `stream_merge_set` :496). Both set the lanes of 128-lane rows under
// a mask: K4 with unique rows, K5 with duplicate rows whose masks are
// disjoint, merged on the MXU block by block. That masked set is this
// kernel on the planes' flat [R * W, 1] views, with one index per masked
// element (row * W + lane): the (row, lane) pairs are unique, so no two
// threads write one element and no combine pass is needed. The callers do
// exactly that for the one-hot bucket-plane writes (one lane per row), and
// set whole rows of the row-major values planes. One difference from K4 is
// deliberate: K4 clipped idx >= R onto row R - 1, while K5 and every caller
// drop it; this kernel drops it.
//
// Bound: device memory. The least traffic is the indices (4n bytes), each
// tensor value read once and each plane's n * W elements written once. The
// bucket-plane writes are scattered 4-byte stores, each in a 32-byte sector
// of its own, so the device moves more than the bytes counted; the train
// step's and a restore batch's calls are small, and their cost was the
// launches and the per-plane preparation ops on the host. So one launch
// writes every plane that shares the index (the train step's key_hi,
// key_lo, freq and last), and a scalar costs no tensor.
//
// Design: one thread per 16-byte vector of a row (or the widest access the
// row width and every pointer's alignment allow, down to one element),
// grid-stride; it loads its index once and stores to each plane. The element
// type is only a bit width (the kernel copies bits), so one template covers
// int32, f32 and bf16. Offsets are 64-bit (flat views of 2^31 elements).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

}  // namespace

// The planes of one launch; mirrored by a ctypes.Structure in
// kernels/row_scatter_set.py.
struct SetPlanes {
  void* plane[kMaxPlanes];
  const void* upd[kMaxPlanes];  // [n, W] values, or null for a scalar
  uint32_t scalar[kMaxPlanes];  // the scalar's bits, repeated to 32 bits
  int k;                        // planes in use
};

namespace {

struct alignas(16) Vec16 { uint4 v; };
struct alignas(8) Vec8 { uint2 v; };

__device__ __forceinline__ Vec16 splat(uint32_t s, Vec16*) { return Vec16{make_uint4(s, s, s, s)}; }
__device__ __forceinline__ Vec8 splat(uint32_t s, Vec8*) { return Vec8{make_uint2(s, s)}; }
__device__ __forceinline__ uint32_t splat(uint32_t s, uint32_t*) { return s; }
__device__ __forceinline__ uint16_t splat(uint32_t s, uint16_t*) { return (uint16_t)s; }

long long blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return b > kMaxBlocks ? kMaxBlocks : b;
}

template <typename V>
__global__ void row_set_kernel(const SetPlanes sp, const int32_t* __restrict__ idx,
                               long long n, long long rows, int vecs_per_row) {
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long j = e / vecs_per_row;
    const long long r = __ldg(idx + j);
    if (r < 0 || r >= rows) continue;
    const long long dst = r * vecs_per_row + (e - j * vecs_per_row);
    // unrolled, so that each plane's pointers are read at a fixed offset of
    // the argument struct
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      if (p < sp.k) {
        const V* u = (const V*)sp.upd[p];
        ((V*)sp.plane[p])[dst] = u ? u[e] : splat(sp.scalar[p], (V*)nullptr);
      }
    }
  }
}

template <typename V>
void launch_rows(const SetPlanes& sp, const void* idx, long long n, long long rows,
                 long long row_bytes, cudaStream_t s) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  row_set_kernel<V><<<(unsigned)blocks_for(n * vpr), kThreads, 0, s>>>(
      sp, (const int32_t*)idx, n, rows, vpr);
}

}  // namespace

// elem_bytes is 2 or 4; every plane is [rows, width] of that size.
extern "C" int meepo_row_scatter_set(const SetPlanes* planes, const void* idx,
                                     long long n, long long rows, long long width,
                                     int elem_bytes, void* stream) {
  if (n <= 0 || planes->k <= 0) return 0;
  if (planes->k > kMaxPlanes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = width * elem_bytes;
  uintptr_t addr = 0;
  for (int p = 0; p < planes->k; ++p) {
    addr |= (uintptr_t)planes->plane[p] | (uintptr_t)planes->upd[p];
  }
  int vec = 16;
  while (vec > elem_bytes && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  switch (vec) {
    case 16: launch_rows<Vec16>(*planes, idx, n, rows, row_bytes, s); break;
    case 8: launch_rows<Vec8>(*planes, idx, n, rows, row_bytes, s); break;
    case 4: launch_rows<uint32_t>(*planes, idx, n, rows, row_bytes, s); break;
    default: launch_rows<uint16_t>(*planes, idx, n, rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
