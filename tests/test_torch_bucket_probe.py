"""The table's bucket probe (`kernels.bucket_probe`): its plain version
against the JAX package's `xla_ops.probe` on the CPU, and the CUDA kernel
against the plain version, bit for bit, on the card.

The tables are planted by hand, so every position of the probe walk holds
keys (resolved in its first to fourth bucket), some keys are absent, some
ids are invalid padding (the sentinel pair, which matches every empty
lane), and, in the `twice` tables, keys sit in two lanes of a bucket, in
both buckets of a pair and in two round groups, where the first bucket of
the walk and its lowest lane win. On the card, the kernel also probes a
2^20-bucket table filled through `insert_rows` to load 0.76, and keys that
the CPU path placed.

The card cases are marked `gpu` and skip without a CUDA device (decided
inside the test). The file imports JAX only inside the CPU cases' helper,
so on a machine with PyTorch alone the card cases run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bucket_probe.py
"""

import numpy as np
import pytest
import torch

from meepoembedding_tpu_torch.config import TableConfig
from meepoembedding_tpu_torch.kernels import bucket_probe, bucket_probe_plain
from meepoembedding_tpu_torch.table import hashing
from meepoembedding_tpu_torch.table import layout as tl
from meepoembedding_tpu_torch.table import table_ops as tx

torch.set_num_threads(1)

LANES = 128


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel builds and runs only on the card")
    return torch.device("cuda")


def _walk(b0: int, nb: int, rounds: int) -> list:
    """The buckets a key of home bucket b0 visits, in probe order."""
    if nb == 1:
        return [0]
    p0 = b0 >> 1
    return [2 * (p0 ^ g) + h for g in range((min(rounds, nb) + 1) // 2) for h in (0, 1)]


def _home(hi: np.ndarray, lo: np.ndarray, nb: int) -> np.ndarray:
    return hashing.bucket_of(torch.from_numpy(hi), torch.from_numpy(lo), nb).numpy()


def _planted(nb: int, rounds: int, seed: int, twice: bool = False):
    """(key_hi, key_lo, uh, ul, valid, want) on the CPU: [nb, 128] planes
    holding random ids, each at a random position of its walk and a random
    free lane; the probe set is every planted id, absent ids, invalid
    padding and one planted id masked invalid. `want` maps a key's index in
    the probe set to the slot it must resolve to (-1: absent)."""
    rng = np.random.default_rng(seed)
    per_bucket = 96 if nb <= 2 else 40
    ids = np.unique(rng.integers(-(2**63) + 1, 2**63 - 1, size=per_bucket * nb + 64,
                                 dtype=np.int64))
    rng.shuffle(ids)
    hi, lo = hashing.split_ids(ids)
    b0 = _home(hi, lo, nb)
    key_hi = np.full((nb, LANES), hashing.EMPTY_HI, np.int32)
    key_lo = np.full((nb, LANES), hashing.EMPTY_LO, np.int32)
    free = [list(rng.permutation(LANES)) for _ in range(nb)]
    want = {}

    def plant(i, b, lane=None):
        lane = free[b].pop() if lane is None else lane
        if lane in free[b]:
            free[b].remove(lane)
        key_hi[b, lane], key_lo[b, lane] = hi[i], lo[i]
        return b * LANES + lane

    absent = 64  # the first 64 ids are never planted
    for i in range(absent):
        want[i] = -1
    dup = set()
    if twice:
        # the same key in two lanes of its first bucket, in both buckets of
        # its first pair, and in the odd bucket of group 0 and the even one
        # of group 1: the first bucket of the walk wins, and there its
        # lowest lane
        for k, i in enumerate(range(absent, absent + 6)):
            walk = _walk(int(b0[i]), nb, rounds)
            if k < 2:
                lanes = sorted(free[walk[0]][-2:])
                plant(i, walk[0], lanes[1])
                want[i] = plant(i, walk[0], lanes[0])
            elif k < 4 and len(walk) >= 2:
                plant(i, walk[1])
                want[i] = plant(i, walk[0])
            elif len(walk) >= 3:
                plant(i, walk[2])
                want[i] = plant(i, walk[1])
            else:
                want[i] = plant(i, walk[0])
            dup.add(i)
    for i in range(absent, len(ids)):
        if i in dup:
            continue
        walk = _walk(int(b0[i]), nb, rounds)
        b = walk[rng.integers(0, len(walk))]
        want[i] = plant(i, b) if free[b] else -1
    pad = 40
    uh = np.concatenate([hi, np.full(pad, hashing.EMPTY_HI, np.int32)])
    ul = np.concatenate([lo, np.full(pad, hashing.EMPTY_LO, np.int32)])
    valid = np.concatenate([np.ones(len(ids), bool), np.zeros(pad, bool)])
    masked = absent + 7  # a planted id the caller masks out
    valid[masked] = False
    want[masked] = -1
    want_slot = np.array([want[i] for i in range(len(ids))] + [-1] * pad, np.int32)
    return (torch.from_numpy(key_hi), torch.from_numpy(key_lo), torch.from_numpy(uh),
            torch.from_numpy(ul), torch.from_numpy(valid), torch.from_numpy(want_slot))


def _jax_probe(key_hi, key_lo, uh, ul, valid, rounds):
    """The JAX package's probe on the same planes and keys, as numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from meepoembedding_tpu.config import TableConfig as JTableConfig
    from meepoembedding_tpu.table import layout as jl
    from meepoembedding_tpu.table import xla_ops as jx

    nb = key_hi.shape[0]
    jspec = jl.TableSpec.from_config(JTableConfig(dim=8, capacity=nb * LANES,
                                                  max_probe_rounds=rounds))
    assert jspec.num_buckets == nb
    jshard = jl.alloc_shard(jspec)._replace(key_hi=jnp.asarray(key_hi.numpy()),
                                            key_lo=jnp.asarray(key_lo.numpy()))
    pr = jx.probe(jspec, jshard, jnp.asarray(uh.numpy()), jnp.asarray(ul.numpy()),
                  jnp.asarray(valid.numpy()))
    return np.asarray(pr.slot), np.asarray(pr.found)


def _positions(slot, uh, ul, nb: int) -> np.ndarray:
    """For found keys, the 1-based position in its walk of the bucket that
    resolved it."""
    s = slot.numpy()
    hit = s >= 0
    b = s[hit] // LANES
    p0 = _home(uh.numpy()[hit], ul.numpy()[hit], nb) >> 1
    return 1 + 2 * ((b >> 1) ^ p0) + (b & 1) if nb > 1 else np.ones(len(b), np.int64)


TABLES = [(1, 3), (1, 4), (2, 3), (2, 4), (16, 1), (16, 2), (16, 3), (16, 4)]


@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("nb,rounds", TABLES)
def test_plain_matches_jax_probe(nb, rounds, twice):
    key_hi, key_lo, uh, ul, valid, want = _planted(nb, rounds, seed=nb * 10 + rounds,
                                                   twice=twice)
    slot, found = bucket_probe(key_hi, key_lo, uh, ul, valid, rounds)
    jslot, jfound = _jax_probe(key_hi, key_lo, uh, ul, valid, rounds)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(found.numpy(), jfound)
    np.testing.assert_array_equal(slot.numpy(), want.numpy())
    assert torch.equal(found, want >= 0)
    assert bool(found.any()) and bool((~found & valid).any())
    # every position of the walk resolves some keys: the chains are exercised
    walk = 1 if nb == 1 else 2 * ((min(rounds, nb) + 1) // 2)
    assert set(np.unique(_positions(slot, uh, ul, nb))) == set(range(1, walk + 1))


def test_probe_goes_through_bucket_probe():
    """`table_ops.probe` is the wrapper on the shard's planes and the
    spec's rounds."""
    spec = tl.TableSpec.from_config(TableConfig(dim=8, capacity=16 * LANES, max_probe_rounds=3))
    shard = tl.alloc_shard(spec, "cpu")
    key_hi, key_lo, uh, ul, valid, want = _planted(16, 3, seed=5, twice=True)
    shard.key_hi.copy_(key_hi)
    shard.key_lo.copy_(key_lo)
    pr = tx.probe(spec, shard, uh, ul, valid)
    assert torch.equal(pr.slot, want) and torch.equal(pr.found, want >= 0)


def _refusal_cases():
    kh = torch.full((16, LANES), hashing.EMPTY_HI, dtype=torch.int32)
    kl = torch.zeros((16, LANES), dtype=torch.int32)
    uh = torch.zeros(8, dtype=torch.int32)
    ok = torch.ones(8, dtype=torch.bool)
    wide = torch.zeros((16, 2 * LANES), dtype=torch.int32)
    return {
        "plane_not_128_lanes": ((wide, wide, uh, uh, ok, 4), "contiguous"),
        "plane_not_int32": ((kh.long(), kl, uh, uh, ok, 4), "int32 plane"),
        "plane_not_contiguous": ((wide[:, ::2], kl, uh, uh, ok, 4), "contiguous"),
        "planes_differ": ((kh, kl[:8], uh, uh, ok, 4), "contiguous"),
        "nb_not_power_of_two": ((kh[:12], kl[:12], uh, uh, ok, 4), "power of two"),
        "keys_not_int32": ((kh, kl, uh.long(), uh, ok, 4), "uh must be"),
        "mask_not_bool": ((kh, kl, uh, uh, ok.int(), 4), "valid must be"),
        "lengths_differ": ((kh, kl, uh, uh[:4], ok, 4), "ul must be"),
        "not_cpu_or_cuda": ((kh.to("meta"), kl.to("meta"), uh.to("meta"), uh.to("meta"),
                             ok.to("meta"), 4), "not a CUDA device"),
        "mixed_devices": ((kh, kl, uh, uh.to("meta"), ok, 4), "one CUDA device"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrapper_refuses(case):
    args, match = _refusal_cases()[case]
    with pytest.raises(ValueError, match=match):
        bucket_probe(*args)


# --- on the card -----------------------------------------------------------------------------

def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("nb,rounds", TABLES)
def test_kernel_matches_plain(nb, rounds, twice):
    dev = _cuda()
    key_hi, key_lo, uh, ul, valid, want = _on(dev, *_planted(nb, rounds, seed=nb * 10 + rounds,
                                                             twice=twice))
    before = bucket_probe.launches
    slot, found = bucket_probe(key_hi, key_lo, uh, ul, valid, rounds)
    torch.cuda.synchronize()
    assert bucket_probe.launches == before + 1
    pslot, pfound = bucket_probe_plain(key_hi, key_lo, uh, ul, valid, rounds)
    assert torch.equal(slot, pslot) and torch.equal(found, pfound)
    assert torch.equal(slot, want)


@pytest.mark.gpu
def test_kernel_at_n_0_launches_nothing():
    dev = _cuda()
    key_hi, key_lo, uh, ul, valid, _ = _on(dev, *_planted(16, 4, seed=3))
    before = bucket_probe.launches
    slot, found = bucket_probe(key_hi, key_lo, uh[:0], ul[:0], valid[:0], 4)
    assert bucket_probe.launches == before
    assert slot.shape == (0,) and found.shape == (0,)
    assert slot.dtype == torch.int32 and found.dtype == torch.bool


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 9, 1001, 12_345])
def test_kernel_at_n_no_block_divides(n):
    """n keys over blocks of 8 warps: the last block is part empty."""
    dev = _cuda()
    key_hi, key_lo, uh, ul, valid, _ = _on(dev, *_planted(16, 4, seed=n))
    reps = -(-n // uh.shape[0])
    uh, ul, valid = (t.repeat(reps)[:n] for t in (uh, ul, valid))
    slot, found = bucket_probe(key_hi, key_lo, uh, ul, valid, 4)
    pslot, pfound = bucket_probe_plain(key_hi, key_lo, uh, ul, valid, 4)
    assert torch.equal(slot, pslot) and torch.equal(found, pfound)


def _fill(spec, shard, ids: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
    """insert_rows of `ids` in chunks; the mask of those that landed."""
    landed = []
    for a in range(0, ids.shape[0], chunk):
        hi, lo = hashing.split_ids_t(ids[a:a + chunk])
        rows = torch.zeros((hi.shape[0], spec.dim), device=ids.device)
        landed.append(tx.insert_rows(spec, shard, hi, lo, rows, hashing.is_valid(hi, lo), 0))
    return torch.cat(landed)


@pytest.mark.gpu
def test_kernel_on_a_2_20_bucket_table_at_load_076():
    dev = _cuda()
    spec = tl.TableSpec.from_config(TableConfig(dim=1, capacity=1 << 27, max_probe_rounds=4))
    assert spec.num_buckets == 1 << 20
    shard = tl.alloc_shard(spec, dev)
    g = torch.Generator(device=dev).manual_seed(76)
    ids = torch.randint(1, 2**62, (int(0.76 * (1 << 27)),), device=dev, dtype=torch.int64,
                        generator=g)
    landed = _fill(spec, shard, ids)
    assert float(landed.float().mean()) > 0.99
    # a probe set of landed ids, unknown ids and padding
    n = 1 << 18
    pick = ids[landed][torch.randint(0, int(landed.sum()), (n - 8192,), device=dev,
                                     generator=g)]
    unknown = -torch.randint(1, 2**62, (4096,), device=dev, dtype=torch.int64, generator=g)
    pad = torch.full((4096,), int(hashing.EMPTY_ID), device=dev, dtype=torch.int64)
    uh, ul = hashing.split_ids_t(torch.cat([pick, unknown, pad]))
    valid = hashing.is_valid(uh, ul)
    slot, found = bucket_probe(shard.key_hi, shard.key_lo, uh, ul, valid, 4)
    pslot, pfound = bucket_probe_plain(shard.key_hi, shard.key_lo, uh, ul, valid, 4)
    assert torch.equal(slot, pslot) and torch.equal(found, pfound)
    assert bool(found[: n - 8192].all()) and not bool(found[n - 8192:].any())
    s = slot[: n - 8192].long()
    assert torch.equal(shard.key_hi.view(-1)[s], uh[: n - 8192])
    assert torch.equal(shard.key_lo.view(-1)[s], ul[: n - 8192])
    # at this load, keys overflow their first bucket
    pos = _positions(slot.cpu(), uh.cpu(), ul.cpu(), spec.num_buckets)
    assert pos.max() >= 2


@pytest.mark.gpu
def test_kernel_finds_what_the_cpu_path_placed():
    """A 64-bucket table filled on the CPU past load 0.8 (overflow chains)
    through insert_rows, its planes moved to the card: the kernel's hash
    and walk find every key where the CPU probe found it."""
    dev = _cuda()
    spec = tl.TableSpec.from_config(TableConfig(dim=4, capacity=64 * LANES, max_probe_rounds=4))
    shard = tl.alloc_shard(spec, "cpu")
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(np.unique(rng.integers(-(2**63) + 1, 2**63 - 1, size=7000,
                                                  dtype=np.int64)))
    _fill(spec, shard, ids)
    hi, lo = hashing.split_ids_t(torch.cat([ids, -ids[:500]]))
    valid = hashing.is_valid(hi, lo)
    cpu = tx.probe(spec, shard, hi, lo, valid)
    assert int(cpu.found.sum()) > 0.8 * spec.capacity
    slot, found = bucket_probe(*_on(dev, shard.key_hi, shard.key_lo, hi, lo, valid), 4)
    assert torch.equal(slot.cpu(), cpu.slot) and torch.equal(found.cpu(), cpu.found)


@pytest.mark.gpu
def test_kernel_refuses_mixed_devices():
    dev = _cuda()
    key_hi, key_lo, uh, ul, valid, _ = _planted(16, 4, seed=1)
    with pytest.raises(ValueError, match="one CUDA device"):
        bucket_probe(key_hi.to(dev), key_lo.to(dev), uh, ul.to(dev), valid.to(dev), 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        bucket_probe(key_hi, key_lo, uh.to(dev), ul.to(dev), valid.to(dev), 4)
