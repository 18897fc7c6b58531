"""The port's weight-residency cache held against the JAX package's.

The same operation sequences (put, lookup, peek, pin, unpin, refresh,
invalidate, clear) run through both caches, over torch tensors in the port
and numpy arrays in the JAX package; ``counters()``, the key order and every
return value must be equal after each operation.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core.residency import ResidencyCache as JaxResidencyCache
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.schedcheck import HazardError

OPS = ("put", "put_pinned", "lookup", "peek", "pin", "unpin_all", "refresh", "invalidate", "clear")


def _trees(nbytes: int):
    """A group of ``nbytes`` bytes in each package's form."""
    n = nbytes // 4
    return {"w": torch.zeros(n, dtype=torch.float32)}, {"w": np.zeros(n, np.float32)}


def _apply(cache, op, key, tree, nb):
    if op == "put":
        return cache.put(key, tree)
    if op == "put_pinned":
        return cache.put(key, tree, nb, pinned=True)
    if op == "lookup":
        return cache.lookup(key) is not None
    if op == "peek":
        return cache.peek(key) is not None
    if op == "pin":
        return cache.pin(key)
    if op == "unpin_all":
        return cache.unpin_all()
    if op == "refresh":
        return cache.refresh(key, tree)
    if op == "invalidate":
        return cache.invalidate(key)
    return cache.clear()


@pytest.mark.parametrize("capacity", [None, 0, 64, 256, 1000])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_counters_equal_jax_over_random_sequences(capacity, seed):
    rng = np.random.default_rng(seed)
    ours, theirs = ResidencyCache(capacity), JaxResidencyCache(capacity)
    for _ in range(300):
        op = OPS[rng.integers(len(OPS) - 1)] if rng.random() > 0.01 else "clear"
        key = f"g{rng.integers(8):03d}"
        nb = 4 * int(rng.integers(1, 80))
        t_ours, t_theirs = _trees(nb)
        assert _apply(ours, op, key, t_ours, nb) == _apply(theirs, op, key, t_theirs, nb), op
        assert ours.counters() == theirs.counters()
        assert list(ours.keys()) == list(theirs.keys())
        assert ours.pinned_bytes == theirs.pinned_bytes and len(ours) == len(theirs)


def test_lru_pins_and_refusals_match_jax():
    ours, theirs = ResidencyCache(300), JaxResidencyCache(300)
    for cache, trees in ((ours, 0), (theirs, 1)):
        for key, nb, pinned in (("a", 100, True), ("b", 100, False), ("c", 100, False)):
            cache.put(key, _trees(nb)[trees], pinned=pinned)
        cache.lookup("b")
        assert cache.put("d", _trees(200)[trees]) is True  # evicts c, then b: a is pinned
        assert cache.put("e", _trees(400)[trees]) is False  # refused, cache unchanged
    assert ours.counters() == theirs.counters()
    assert list(ours.keys()) == list(theirs.keys()) == ["a", "d"]


def test_evicted_group_is_released():
    """An evicted entry drops the cache's reference to its tree, so the
    allocator can reuse the bytes once no step holds them."""
    cache = ResidencyCache(100)
    t = torch.zeros(20)
    ref = weakref.ref(t)
    cache.put("a", {"w": t})
    del t
    gc.collect()
    assert ref() is not None
    cache.put("b", {"w": torch.zeros(20)})  # 80 + 80 > 100: evicts a
    gc.collect()
    assert ref() is None and "a" not in cache
    cache.clear()
    assert cache.resident_bytes == 0 and len(cache) == 0


def test_sanitize_home_catches_a_swapped_home():
    cache = ResidencyCache(None, sanitize=True)
    home = {"w": np.arange(8, dtype=np.float32)}
    cache.sanitize_home("g", home, hit=False)
    cache.sanitize_home("g", home, hit=True)  # the same home: fine
    with pytest.raises(HazardError, match="stale residency RAW"):
        cache.sanitize_home("g", {"w": np.arange(8, dtype=np.float32)}, hit=True)
    home["w"][0] = 7  # mutated in place: the CRC sees it
    cache.sanitize_home("h", home, hit=False)
    home["w"][1] = 9
    with pytest.raises(HazardError):
        cache.sanitize_home("h", home, hit=True)


def test_sanitize_defaults_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert ResidencyCache().sanitize and JaxResidencyCache().sanitize
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not ResidencyCache().sanitize
    with pytest.raises(ValueError, match="capacity_bytes must be >= 0"):
        ResidencyCache(-1)
