// Bucket probe of the dynamic table: for each key (hi, lo) with valid[j],
// the slot b * 128 + lane of the first bucket b, in probe order, whose lane
// holds both words of the key, the lowest such lane; -1 and not found
// otherwise. Probe order, for a table of nb buckets (a power of two) and
// G = ceil(min(rounds, nb) / 2) round groups: with b0 the key's home bucket
// and p0 = b0 >> 1, buckets 2 (p0 ^ g) and then 2 (p0 ^ g) + 1 for
// g = 0 .. G - 1; bucket 0 alone where nb == 1. The walk stops at the first
// hit, so a key planted twice resolves as the plain version resolves it
// (kernels/bucket_probe.py `bucket_probe_plain`, the port of
// meepoembedding_tpu/table/xla_ops.py:59 `probe`).
//
// Replaces no TPU kernel: the JAX package's probe is plain XLA code, one
// [n, 512] gather of both key planes a round group and broadcast compares,
// with no branch (a lax.cond cost more than a round there). On the card
// that code was some 140 eager operations a call (the int64 murmur3 of the
// home bucket, and a gather, four compares, two `any`, two `argmax` and a
// dozen `where` a round group), so the host's issue time, not the device,
// set a call's time. Here one launch does it all: the hash, every round,
// the first-lane match, the early exit.
//
// Bound: device memory. A key reads its 9 input bytes and writes 5; each
// bucket it visits costs one 512-byte row of key_lo and, only in the lanes
// whose low word matched (none or one, almost always), a 16-byte vector of
// key_hi: about 516 B a bucket, against 1 KB for both rows. The least time
// is (14 n + 512 x buckets visited + 16 x hits) bytes / 3.35 TB/s on an
// H100 SXM.
//
// Design: a warp a key. Each thread holds 4 of the bucket's 128 lanes, one
// 16-byte read-only load of key_lo, so a bucket row is one coalesced 512 B
// read. A `__ballot_sync` of the threads with a full match (key_hi loaded
// only where key_lo matched) picks the lowest matching thread with `__ffs`,
// whose lowest matching lane comes over a shuffle. Every thread computes
// the hash itself (murmur3 in native uint32 arithmetic, the bits of
// table/hashing.py `bucket_of`): a broadcast load of the key and no
// shuffle. The chain of a key is three dependent memory reads (key, key_lo
// row, key_hi vector) a bucket, so latency is hidden by occupancy: blocks
// of 8 warps, 24 registers a thread, 64 warps resident an SM, a warp
// for every key up to the grid's cap and a grid-stride loop past it.
// Reading both buckets of a round group's pair at once (one round trip for
// 1 KB) measured 5-9% slower at 32K-262K keys on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kVecsPerBucket = kLanes / 4;  // int4 vectors in a bucket row
constexpr uint32_t kSaltBucket = 0x2545F491u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// hashing.hash_pair(hi, lo, SALT_BUCKET)
__device__ __forceinline__ uint32_t bucket_hash(uint32_t hi, uint32_t lo) {
  const uint32_t h = (lo * 0xCC9E2D51u) ^ (hi * 0x1B873593u) ^ kSaltBucket;
  return fmix32(h ^ (fmix32(hi) >> 1));
}

__device__ __forceinline__ unsigned eq4(int4 v, int32_t k) {
  return (unsigned)(v.x == k) | ((unsigned)(v.y == k) << 1) | ((unsigned)(v.z == k) << 2) |
         ((unsigned)(v.w == k) << 3);
}

__global__ void __launch_bounds__(kThreads) bucket_probe_kernel(
    const int4* __restrict__ key_hi, const int4* __restrict__ key_lo,
    const int32_t* __restrict__ uh, const int32_t* __restrict__ ul,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ slot,
    uint8_t* __restrict__ found, long long n, uint32_t nb, int visits) {
  const int t = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); j < n; j += warps) {
    // all three loads issued before the branch: one round trip, not two
    const uint8_t v = __ldg(valid + j);
    const int32_t hi = __ldg(uh + j), lo = __ldg(ul + j);
    int32_t s = -1;
    if (v) {
      const uint32_t p0 = (bucket_hash((uint32_t)hi, (uint32_t)lo) & (nb - 1)) >> 1;
      for (int k = 0; k < visits; ++k) {
        const uint32_t b = nb == 1 ? 0u : ((p0 ^ (uint32_t)(k >> 1)) << 1) | (uint32_t)(k & 1);
        const size_t at = (size_t)b * kVecsPerBucket + t;
        unsigned m = eq4(__ldg(key_lo + at), lo);
        if (m) m &= eq4(__ldg(key_hi + at), hi);
        const unsigned hit = __ballot_sync(0xffffffffu, m != 0);
        if (hit) {  // the same on every thread of the warp
          const int src = __ffs(hit) - 1;
          const int c = __shfl_sync(0xffffffffu, __ffs(m) - 1, src);
          s = (int32_t)(b * kLanes + 4 * src + c);
          break;
        }
      }
    }
    if (t == 0) {
      slot[j] = s;
      found[j] = s >= 0;
    }
  }
}

}  // namespace

// key_hi, key_lo: [nb, 128] int32, 16-byte aligned; uh, ul: [n] int32;
// valid, found: [n] bool (one byte each); slot: [n] int32. `groups` is
// ceil(min(rounds, nb) / 2) (0 probes nothing) and is not read where nb == 1.
extern "C" int meepo_bucket_probe(const void* key_hi, const void* key_lo, const void* uh,
                                  const void* ul, const void* valid, void* slot, void* found,
                                  long long n, long long nb, int groups, void* stream) {
  if (n <= 0) return 0;
  if (nb <= 0 || (nb & (nb - 1)) != 0 || nb > (1LL << 24) || groups < 0)
    return (int)cudaErrorInvalidValue;
  const int visits = nb == 1 ? 1 : 2 * groups;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  bucket_probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)key_hi, (const int4*)key_lo, (const int32_t*)uh, (const int32_t*)ul,
      (const uint8_t*)valid, (int32_t*)slot, (uint8_t*)found, n, (uint32_t)nb, visits);
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
