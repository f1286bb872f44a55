"""The port's tier-2 table ops (``repro_torch.core.cache``) against the JAX
reference's (``repro.core.cache``), bit for bit: the set hash (including
negative keys and keys whose multiply overflows int64), and batched
probe/insert sequences under all three policies with duplicate keys in a
batch — the same table contents, admit and evict counts, hits, values and
LRU stamps after every step."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core import cache as rc
from repro_torch.core import cache as tc

I64 = np.iinfo(np.int64)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(I64.min, I64.max, size=n, dtype=np.int64)
    special = np.array([0, 1, -1, 2, -2, I64.min, I64.max, I64.min + 1,
                        I64.max - 1, 1 << 62, -(1 << 62), 12345678901234],
                       np.int64)
    return np.concatenate([special, keys])


@pytest.mark.parametrize("n_sets", [1, 7, 64, 1000, (1 << 20) + 3])
def test_hash_sets_bit_for_bit(n_sets):
    keys = _keys(n_sets, 4000)
    with enable_x64():
        want = np.asarray(rc._hash_sets(jnp.asarray(keys), n_sets))
    got = tc._hash_sets(torch.from_numpy(keys), n_sets).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < n_sets).all()


def _table(ways, sets):
    z = lambda dt: np.zeros((sets, ways), dt)  # noqa: E731
    return [z(np.int64), z(np.int64), z(bool), z(np.int32), z(np.int64)]


def _batches(seed, C, steps, key_range):
    """Insert batches with duplicate keys (small key range), sparse
    activity and repeated keys across batches."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        keys = rng.integers(-key_range, key_range, size=C).astype(np.int64)
        keys[rng.random(C) < 0.2] = keys[0]  # in-batch duplicates
        vals = rng.integers(0, 50, size=C).astype(np.int64)
        costs = np.maximum(vals, 1)
        active = rng.random(C) < 0.7
        yield keys, vals, costs, active


CASES = [("direct", 1, 16), ("setassoc", 4, 8), ("setassoc", 2, 32),
         ("costaware", 4, 8), ("costaware", 8, 4)]


@pytest.mark.parametrize("policy,ways,sets", CASES)
def test_probe_and_insert_match_reference(policy, ways, sets):
    C = 96
    r_tab = _table(ways, sets)
    t_tab = [torch.from_numpy(a.copy()) for a in r_tab]
    rounds = min(ways, 8)
    for step, (keys, vals, costs, active) in enumerate(
            _batches(ways * 31 + sets, C, 6, 40)):
        tick = 2 * step + 1
        with enable_x64():
            out = rc._insert(*map(jnp.asarray, r_tab), jnp.asarray(keys),
                             jnp.asarray(vals), jnp.asarray(costs),
                             jnp.asarray(active), jnp.int32(tick),
                             policy=policy, rounds=rounds)
            r_tab = [np.asarray(a) for a in out[:5]]
            r_admit, r_evict = int(out[5]), int(out[6])
        out_t = tc._insert(*t_tab, torch.from_numpy(keys),
                           torch.from_numpy(vals), torch.from_numpy(costs),
                           torch.from_numpy(active), tick, policy=policy,
                           rounds=rounds)
        t_tab = list(out_t[:5])
        assert (int(out_t[5]), int(out_t[6])) == (r_admit, r_evict), step
        for name, a, b in zip(("keys", "vals", "used", "stamp", "cost"),
                              t_tab, r_tab):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"step {step}: {name}")
        # probe a batch mixing resident keys, misses and inactive rows
        qkeys = np.concatenate([keys[: C // 2],
                                keys[C // 2:] + 1]).astype(np.int64)
        qactive = np.roll(active, 3)
        with enable_x64():
            hit, hv, stamp = rc._probe(
                *map(jnp.asarray, (r_tab[0], r_tab[1], r_tab[2], r_tab[3],
                                   qkeys, qactive)), jnp.int32(tick + 1))
        t_hit, t_hv, t_stamp = tc._probe(
            t_tab[0], t_tab[1], t_tab[2], t_tab[3],
            torch.from_numpy(qkeys), torch.from_numpy(qactive), tick + 1)
        np.testing.assert_array_equal(t_hit.numpy(), np.asarray(hit))
        np.testing.assert_array_equal(t_hv.numpy(), np.asarray(hv))
        np.testing.assert_array_equal(t_stamp.numpy(), np.asarray(stamp))
        assert t_hit.any(), "probe batch must hit something"
        r_tab[3] = np.asarray(stamp)
        t_tab[3] = t_stamp


@pytest.mark.parametrize("policy", ["direct", "setassoc", "costaware"])
def test_device_cache_resize_matches_reference(policy):
    """A dynamic table that grows and shrinks: the same rehash results and
    the same stats as the reference's DeviceCache."""
    kw = dict(policy=policy, slots=16, assoc=4, dynamic=True,
              resize_interval=2, min_slots=4, max_slots=1 << 10)
    with enable_x64():
        r = rc.DeviceCache.create(rc.CacheConfig(**kw))
    t = tc.DeviceCache.create(tc.CacheConfig(**kw), device="cpu")
    for step, (keys, vals, _costs, active) in enumerate(
            _batches(3, 64, 8, 1000)):
        with enable_x64():
            r.probe(jnp.asarray(keys), jnp.asarray(active))
            r.insert(jnp.asarray(keys), jnp.asarray(vals),
                     jnp.asarray(active))
            r_delta = r.maybe_resize()
        t.probe(torch.from_numpy(keys), torch.from_numpy(active))
        t.insert(torch.from_numpy(keys), torch.from_numpy(vals),
                 torch.from_numpy(active))
        assert t.maybe_resize() == r_delta, step
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(r.keys))
        np.testing.assert_array_equal(t.vals.numpy(), np.asarray(r.vals))
        np.testing.assert_array_equal(t.used.numpy(), np.asarray(r.used))
    rs, ts = r.stats(), t.stats()
    for k in ("hits", "misses", "probes", "inserts", "evictions", "resizes",
              "slots", "occupancy"):
        assert ts[k] == rs[k], k
    assert ts["resizes"] > 0


def test_config_validation_matches_reference():
    for kw in (dict(policy="lru"), dict(assoc=0)):
        with pytest.raises(ValueError):
            rc.CacheConfig(**kw)
        with pytest.raises(ValueError):
            tc.CacheConfig(**kw)
    for kw in (dict(slots=0), dict(slots=3, policy="setassoc"),
               dict(slots=100, budget=40, assoc=8, policy="costaware")):
        assert (tc.CacheConfig(**kw).initial_slots()
                == rc.CacheConfig(**kw).initial_slots())
