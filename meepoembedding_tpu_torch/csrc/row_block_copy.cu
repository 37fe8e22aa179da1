// Random-row block copies of a [nrow, 128] f32 plane, R consecutive rows a
// descriptor from a clipped random base, W descriptors' buffers in flight in
// each block:
//
//   gather   out[j * R + r]            = plane[clip(base[j], 0, nrow - R) + r]
//   scatter  plane[clip(base[j], 0, nrow - R) + r] = upd[j * R + r]   (in place)
//
// for r < R. Replaces the two TPU kernels of the random-row DMA probe
// bench_dma.py: K6, the gather `kernel` of `make_gather(R, W)` (bench_dma.py:76,
// pl.pallas_call :113), and K7, the scatter `kernel` of `make_scatter(R, W)`
// (bench_dma.py:137, pl.pallas_call :177). Each TPU grid step walks 256
// descriptors, one `make_async_copy` a descriptor on a ring of W DMA
// semaphores: descriptor j waits for j - W before it starts.
//
// Bound: device memory. A call reads and writes n * R rows of 512 bytes and
// reads 4n bytes of bases: (2 * n * R * 512 + 4n) bytes / 3.35 TB/s on an H100
// SXM. At R = 1 each row is one random 512-byte access, so the rate of random
// accesses the card sustains, not its streaming rate, is what the probe reads.
//
// Design, the Hopper counterpart of a DMA descriptor and its semaphore: a
// block of eight warps takes the TPU grid step's 256 descriptors; its
// threads load and clip the 256 bases into shared memory (the TPU's scalar
// prefetch). A descriptor's R rows are contiguous, R * 512 bytes, so one 1-D
// bulk copy (TMA, `cp.async.bulk`) moves them all: it lands in a slot of a
// ring of W slots in shared memory and completes on that slot's mbarrier.
// The slot then goes out with one bulk store
// (`cp.async.bulk.global.shared::cta.bulk_group`): to `out` for the gather,
// to the plane's rows for the scatter, whose load reads `upd`. Lane 0 of
// each warp issues: issuer k takes descriptors k, k + 8, ... on its own
// share of the ring (the W slots dealt out, so with W < 8 only W lanes
// issue). A slot is loaded again only after `cp.async.bulk.wait_group.read`
// says its store has read it. So each block has at most W descriptors
// between the start of their load and the end of their store's read, as
// the TPU's ring has W copies in flight; every resident block keeps its own
// ring, so the card has W x (resident blocks) in flight (`occupancy` gives
// the blocks an SM holds). Why eight lanes: one lane's bulk copies issue
// about 0.4 us apart on an H100 whatever is in flight, so with one lane a
// block every point at R <= 4 took about 1.5 ns a descriptor at any W;
// eight bring R = 1 to the rate of the row gather. Issuing each store as
// soon as its load lands, to keep several in flight a lane, gained nothing
// beside them (bench_torch_block_copy_designs.py).
//
// The ring is W * (R * 512 + 8) bytes beside 1 KB of bases; the wrapper
// refuses a ring beyond the 232,448 bytes a block may have. Slots are
// min(W, 256), as the TPU keeps min(W, 256) semaphores. Offsets are 64-bit:
// a 2^22-row plane is 2 GiB. A lane that issues spins on an mbarrier at
// most 2^24 times and then traps, so a lost copy ends the kernel with an
// error instead of hanging the card.
//
// Overlapping blocks: where two descriptors' clipped blocks overlap, the
// scatter writes those rows twice in no defined order (on the TPU the later
// write in grid order wins, outside a window of W). The result is exact where
// the blocks are disjoint.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockDesc = 256;  // descriptors a block: the TPU's grid step
constexpr int kIssuers = 8;      // warps a block; lane 0 of each issues copies
constexpr int kThreads = 32 * kIssuers;
constexpr long long kRowBytes = 512;
constexpr int kMaxSmem = 232448;  // shared memory a block may have (H100)
constexpr long long kSpinLimit = 1LL << 24;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long t = 0; !mbar_try(bar, parity); ++t)
    if (t > kSpinLimit) asm volatile("trap;");
}

// One block: descriptors [blockIdx.x * 256, + 256) of n. Gather: src is the
// plane, dst is out. Scatter: src is upd, dst is the plane.
__global__ void __launch_bounds__(kThreads)
row_block_copy(const char* src, char* dst, const int32_t* __restrict__ base, long long n,
               long long nrow, int R, int slots, int scatter) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long bytes = (long long)R * kRowBytes;
  unsigned char* ring = smem;
  uint64_t* bar = (uint64_t*)(smem + (size_t)slots * bytes);
  int32_t* first = (int32_t*)(bar + slots);  // each descriptor's clipped first row

  const long long d0 = (long long)blockIdx.x * kBlockDesc;
  const int cnt = (int)(n - d0 < kBlockDesc ? n - d0 : kBlockDesc);
  const long long top = nrow - R;
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const long long b = base[d0 + j];
    first[j] = (int32_t)(b < 0 ? 0 : (b > top ? top : b));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(&bar[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int issuers = slots < kIssuers ? slots : kIssuers;
  const int k = threadIdx.x / 32;
  if (threadIdx.x % 32 != 0 || k >= issuers) return;

  // issuer k: descriptors k + i * issuers for i < m, on slots [s0, s0 + per)
  const int per = slots / issuers + (k < slots % issuers);
  const int s0 = k * (slots / issuers) + (k < slots % issuers ? k : slots % issuers);
  const int m = cnt > k ? (cnt - k + issuers - 1) / issuers : 0;
  const uint32_t nbytes = (uint32_t)bytes;
  auto from = [&](int i) -> const char* {
    const int j = k + i * issuers;
    return scatter ? src + (d0 + j) * bytes : src + (long long)first[j] * kRowBytes;
  };
  auto to = [&](int i) -> char* {
    const int j = k + i * issuers;
    return scatter ? dst + (long long)first[j] * kRowBytes : dst + (d0 + j) * bytes;
  };
  // the lane's i-th descriptor goes through slot s0 + i % per, in phase
  // i / per of its barrier
  auto slot = [&](int i) { return s0 + i % per; };
  auto load = [&](int i) {
    const uint32_t b = sa(&bar[slot(i)]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(nbytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(sa(ring + (size_t)slot(i) * bytes)), "l"(from(i)), "r"(nbytes), "r"(b) : "memory");
  };
  // the lane's i-th store, once its load has landed
  auto store = [&](int i) {
    mbar_wait(sa(&bar[slot(i)]), (uint32_t)((i / per) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(to(i)), "r"(sa(ring + (size_t)slot(i) * bytes)), "r"(nbytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  };

  for (int i = 0; i < m; ++i) {
    if (i >= per) {
      // slot(i) holds the lane's descriptor i - per: store it, and load i
      // only after the store has read the slot
      store(i - per);
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    load(i);
  }
  for (int i = m > per ? m - per : 0; i < m; ++i) store(i);
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

size_t smem_bytes(int R, int slots) {
  return (size_t)slots * ((size_t)R * kRowBytes + sizeof(uint64_t)) +
         kBlockDesc * sizeof(int32_t);
}

// the dynamic shared memory limit raised once a device, to all a block may have
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(row_block_copy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace

// scatter 0: src is the [nrow, 128] f32 plane, dst the [n * R, 128] out.
// scatter 1: src is the [n * R, 128] upd, dst the plane. base is [n] int32.
extern "C" int meepo_row_block_copy(int scatter, const void* src, void* dst, const void* base,
                                    long long n, long long nrow, int R, int slots,
                                    void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(R, slots);
  if (R < 1 || R > nrow || slots < 1 || slots > kBlockDesc || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + kBlockDesc - 1) / kBlockDesc);
  row_block_copy<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const char*)src, (char*)dst, (const int32_t*)base, n, nrow, R, slots, scatter);
  return (int)cudaGetLastError();
}

// the blocks of a launch at (R, slots) that one SM holds at once
extern "C" int meepo_row_block_occupancy(int R, int slots, int* blocks_per_sm) {
  const size_t smem = smem_bytes(R, slots);
  if (R < 1 || slots < 1 || slots > kBlockDesc || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, row_block_copy,
                                                            kThreads, smem);
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
