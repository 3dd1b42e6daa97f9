"""Device k-mer table lookup (single-chip and mesh-sharded).

The reference resolves query k-mers one at a time through the open-addressed
probe table (modsetIndexFind, modset.c:45-62; the modmap -q seeding loop,
modmap.c:196-207).  Random probes into an open-addressed table map poorly
onto a vector device, so the device-native design keeps the table as a *sorted* k-mer array with a parallel value
column and answers batches of queries with a vectorized binary search:

- single chip: one sorted array, one jnp.searchsorted + equality check;
- mesh: the table is sharded by the same hash-prefix partition as the
  sharded builder (div_mod_owner of the canonical seqhash), queries are
  routed to their owner shard with the pad-to-cap sort + all_to_all trick
  (no scatters), searched locally, and the answers ride the inverse
  all_to_all back to the querying shard in the exact slots they were sent
  from, then are restored to input order with one small sort by the carried
  slot id.

The probe-table layout stays what it always was — a *serialization format*
(MSHSTv2) — while the device working set is sort-friendly.
"""

import functools

import numpy as np

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.packed import div_mod_owner
from .sharded import U64_SENTINEL, _sort_multi, build_mesh


def _hash_of(kmers, factor1, shift1):
    return (kmers * jnp.uint64(factor1)) >> jnp.uint64(shift1)


@functools.partial(jax.jit, static_argnames=("factor1", "shift1", "w"))
def _find_sorted_local(keys, vals, q, *, factor1, shift1, w):
    """Single-device lookup: keys ascending u64 (sentinel padded), vals u32,
    q u64 queries.  Returns u32 values, 0 where absent."""
    pos = jnp.searchsorted(keys, q)
    pos = jnp.minimum(pos, keys.shape[0] - 1)
    hit = jnp.take(keys, pos) == q
    return jnp.where(hit, jnp.take(vals, pos), jnp.uint32(0))


class DeviceTable:
    """Sorted-kmer device table over a mesh (n=1 degenerates to one array).

    Built from host (kmers, values); queries answered in input order."""

    def __init__(self, kmers: np.ndarray, values: np.ndarray, hasher,
                 mesh=None):
        self.mesh = mesh if mesh is not None else build_mesh()
        self.n = self.mesh.devices.size
        self.sh = hasher
        kmers = np.ascontiguousarray(kmers, np.uint64)
        values = np.ascontiguousarray(values, np.uint32)
        n = self.n
        if n == 1:
            order = np.argsort(kmers)
            pad = 1  # keep at least one sentinel so searchsorted can clamp
            self.keys = jnp.asarray(np.concatenate(
                [kmers[order], np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)]))
            self.vals = jnp.asarray(np.concatenate(
                [values[order], np.zeros(pad, np.uint32)]))
            return
        h = (kmers * np.uint64(self.sh.factor1)) >> np.uint64(self.sh.shift1)
        w = self.sh.w
        if w & (w - 1) == 0:
            q = h >> np.uint64(w.bit_length() - 1)
        else:
            q = h // np.uint64(w)
        owner = (q % np.uint64(n)).astype(np.int64)
        cap = max(8, int(np.bincount(owner, minlength=n).max()) + 1)
        keys = np.full((n, cap), 0xFFFFFFFFFFFFFFFF, np.uint64)
        vals = np.zeros((n, cap), np.uint32)
        for s in range(n):
            sel = owner == s
            ks = kmers[sel]
            o = np.argsort(ks)
            keys[s, :len(ks)] = ks[o]
            vals[s, :len(ks)] = values[sel][o]
        shd = jax.sharding.NamedSharding(self.mesh, P("shard"))
        self.keys = jax.device_put(keys, shd)
        self.vals = jax.device_put(vals, shd)

    def find(self, q_kmers: np.ndarray) -> np.ndarray:
        """Batched lookup; returns u32 values aligned with q_kmers, 0 where
        absent (mirrors modsetIndexFind isAdd=false semantics)."""
        q_kmers = np.ascontiguousarray(q_kmers, np.uint64)
        nq = len(q_kmers)
        if nq == 0:
            return np.zeros(0, np.uint32)
        sh = self.sh
        if self.n == 1:
            out = _find_sorted_local(self.keys, self.vals,
                                     jnp.asarray(q_kmers),
                                     factor1=sh.factor1, shift1=sh.shift1,
                                     w=sh.w)
            return np.asarray(out)
        n = self.n
        qcap = -(-nq // n)
        qpad = np.full(n * qcap, 0xFFFFFFFFFFFFFFFF, np.uint64)
        qpad[:nq] = q_kmers
        shd = jax.sharding.NamedSharding(self.mesh, P("shard"))
        qd = jax.device_put(qpad.reshape(n, qcap), shd)
        # cap for routing: worst case all of one shard's queries go to one
        # owner; overflow is detected and the caller retries wider
        cap = qcap
        while True:
            out, ovf = _sharded_find(self.keys, self.vals, qd,
                                     factor1=sh.factor1, shift1=sh.shift1,
                                     w=sh.w, n_shards=n, cap=cap,
                                     qcap=qcap, mesh=self.mesh)
            if not bool(np.any(np.asarray(ovf))):
                break
            cap *= 2
        return np.asarray(out).reshape(-1)[:nq]


@functools.partial(jax.jit, static_argnames=("factor1", "shift1", "w",
                                             "n_shards", "cap", "qcap",
                                             "mesh"))
def _sharded_find(keys, vals, qs, *, factor1, shift1, w, n_shards, cap,
                  qcap, mesh):
    def step(k_l, v_l, q_l):
        k_l, v_l, q_l = k_l[0], v_l[0], q_l[0]
        h = _hash_of(q_l, factor1, shift1)
        owner = div_mod_owner(h, w, n_shards)
        # every slot routes (sentinel queries simply miss), so the
        # return-trip slot sort restores a dense 0..qcap-1 alignment
        key_real = owner * 2
        key_pad = (jnp.arange(n_shards * cap,
                              dtype=jnp.uint32) // cap) * 2 + 1
        allk = jnp.concatenate([key_real, key_pad])
        slot = jnp.arange(qcap, dtype=jnp.uint32)
        allq = jnp.concatenate([q_l, jnp.full(n_shards * cap, U64_SENTINEL,
                                              jnp.uint64)])
        alls = jnp.concatenate([slot, jnp.full(n_shards * cap,
                                               jnp.uint32(0xFFFFFFFF),
                                               jnp.uint32)])
        sk, sq, ss = _sort_multi([allk], [allq, alls], is_stable=True)
        starts = jnp.searchsorted(sk, jnp.arange(n_shards,
                                                 dtype=jnp.uint32) * 2)
        ends = jnp.searchsorted(sk, jnp.arange(n_shards,
                                               dtype=jnp.uint32) * 2 + 1)
        overflow = jnp.any((ends - starts) > cap)
        j = jnp.arange(n_shards * cap)
        idx = starts[j // cap] + (j % cap)
        send_q = jnp.take(sq, idx)
        send_s = jnp.take(ss, idx)

        def a2a(x):
            return jax.lax.all_to_all(x.reshape(n_shards, cap), "shard",
                                      split_axis=0, concat_axis=0,
                                      tiled=True).reshape(-1)

        recv_q = a2a(send_q)
        # local sorted search on this shard's slice
        pos = jnp.searchsorted(k_l, recv_q)
        pos = jnp.minimum(pos, k_l.shape[0] - 1)
        hit = jnp.take(k_l, pos) == recv_q
        ans = jnp.where(hit & (recv_q != U64_SENTINEL),
                        jnp.take(v_l, pos), jnp.uint32(0))
        back = a2a(ans)   # answers return to the slots they were sent from
        # restore input order: sort (slot, answer); live slots are unique
        o_s, o_a = _sort_multi([send_s], [back])
        return o_a[:qcap][None], overflow[None]

    f = jax.shard_map(step, mesh=mesh, in_specs=(P("shard"),) * 3,
                      out_specs=(P("shard"), P("shard")))
    return f(keys, vals, qs)
