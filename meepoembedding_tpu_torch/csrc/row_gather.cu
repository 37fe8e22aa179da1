// Row gather: out[j] = plane[clamp(idx[j], 0, R - 1)] for an [R, W] plane of
// 2- or 4-byte elements.
//
// Replaces the TPU kernel `_gather_kernel` (meepoembedding_tpu/table/
// pallas_ops.py:58, entry point `row_gather` :110), which kept 256 row DMAs
// in flight per grid step. On the serving path it carries every table read:
// the probe's key-pair rows ([nb/2, 256] int32) and the found rows of the
// values plane ([capacity, dim] f32 or bf16).
//
// Bound: device memory. The work is n rows read, n rows written and 4n
// bytes of indices; there is no arithmetic to speak of, so the least time is
// (2 * n * row_bytes + 4 * n) / 3.35 TB/s on an H100 SXM.
//
// Design: one thread per 16-byte vector of an output row (8 threads for a
// 128-byte row), neighbouring threads on neighbouring addresses, so every
// row is read and written with coalesced 16-byte accesses. The vector width
// drops to 8, 4 or 2 bytes when the row length or the base addresses do not
// allow 16. A grid-stride loop covers any n; offsets are 64-bit because a
// plane may exceed 2^31 elements. Nothing is reused between threads, so the
// kernel uses no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct alignas(16) Vec16 { uint4 v; };
struct alignas(8) Vec8 { uint2 v; };

template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ plane,
                                  const int32_t* __restrict__ idx,
                                  V* __restrict__ out, long long n,
                                  long long rows, int vecs_per_row) {
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long j = e / vecs_per_row;
    const int c = (int)(e - j * vecs_per_row);
    long long r = __ldg(idx + j);
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    out[e] = plane[r * vecs_per_row + c];
  }
}

template <typename V>
void launch(const void* plane, const void* idx, void* out, long long n,
            long long rows, long long row_bytes, cudaStream_t stream) {
  const int vecs_per_row = (int)(row_bytes / (long long)sizeof(V));
  const long long total = n * vecs_per_row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  row_gather_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      (const V*)plane, (const int32_t*)idx, (V*)out, n, rows, vecs_per_row);
}

}  // namespace

extern "C" int meepo_row_gather(const void* plane, const void* idx, void* out,
                                long long n, long long rows,
                                long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t addr = (uintptr_t)plane | (uintptr_t)out;
  int vec = 16;
  while (vec > 2 && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 16: launch<Vec16>(plane, idx, out, n, rows, row_bytes, s); break;
    case 8: launch<Vec8>(plane, idx, out, n, rows, row_bytes, s); break;
    case 4: launch<uint32_t>(plane, idx, out, n, rows, row_bytes, s); break;
    default: launch<uint16_t>(plane, idx, out, n, rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
