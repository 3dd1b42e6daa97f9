"""Batched modmap -q colinear chaining on device.

The reference chains each read's seed list with a tiny sequential automaton
(queryProcess, modmap.c:216-280): greedy blocks over copy1/copy2 seeds,
broken on reference-id change, direction flips, or |diagonal drift| > 50,
with a second-occurrence retry for copy2 seeds, an M record per closed
block with n1 > 2, and a final-block emission gated on n2 > 2 (the
reference's quirk, modmap.c:269).

Device formulation: all reads run the automaton in lockstep as one
`lax.scan` over the padded seed axis — state is six u32 vectors [R], each
step a few dozen vector ops — and the emitted M records (rare) are compacted
per read to `cap` slots with an emit-rank one-hot contraction (int8
operands, 8-bit limbs, s32 accumulation — exact for u32 fields), so the
download is R*cap records, not R*S steps.

Not wired into cli/modmap.py: on the earlier accelerator the native
automaton + text emission was faster (docs/PERF.md); this device path has
not been timed on the GPU (scripts/bench_chain.py).  It remains the
oracle-tested device formulation.
"""

import functools

import numpy as np

import modimizer

modimizer.configure_jax()

import jax
import jax.numpy as jnp

F = 7  # record fields: i0, iN, loc0, locN, n1, n2, is_final


@functools.partial(jax.jit, static_argnames=("cap",))
def chain_scan(loc_a, loc_b, id_a, id_b, is1, live, pos, idmap, *, cap):
    """[R, S] seed planes -> (records [R, cap, F] u32, counts [R] i32,
    overflow bool).

    loc_a/loc_b: first/second reference occurrence of each seed's mod
    (u32); id_a/id_b: their reference sequence ids; is1: copy1; live: seed
    participates (found, copy1|copy2, not multi; padding dead); pos: the
    seed's query position.  Occurrence 0 doubles as "no block open",
    exactly like the reference (loc0 = 0, modmap.c:214).  Records carry
    (pos[i0], pos[iN], loc0, locN, n1, n2, is_final); dead slots are
    0xFFFFFFFF."""
    R, S = loc_a.shape
    z = jnp.zeros(R, jnp.uint32)

    def id_of(loc):
        return jnp.take(idmap, loc)

    def block_break(loc, rid, loc0, locN, i0, iN):
        """modmap.c:232-241: endBlock for candidate loc given open block."""
        same_id = rid == id_of(loc0)
        fwd = loc0 < locN
        rev = loc0 > locN
        d_f = (locN - loc0).astype(jnp.int32) - (iN - i0).astype(jnp.int32)
        d_r = (loc0 - locN).astype(jnp.int32) - (iN - i0).astype(jnp.int32)
        bad_f = (loc < locN) | (d_f > 50) | (d_f < -50)
        bad_r = (loc > locN) | (d_r > 50) | (d_r < -50)
        return ~same_id | (fwd & bad_f) | (rev & bad_r)

    def step2(state, xs):
        loc0, locN, pi0, piN, i0, iN, n1, n2 = state
        la, lb, ia, ib, one, lv, ps, t = xs
        loc, rid = la, ia
        none = loc0 == 0
        end = none | block_break(loc, rid, loc0, locN, i0, iN)
        retry = end & ~none & ~one
        loc = jnp.where(retry, lb, loc)
        rid = jnp.where(retry, ib, rid)
        end = jnp.where(retry,
                        block_break(loc, rid, loc0, locN, i0, iN), end)
        emit = lv & end & (n1 > 2)
        rec = jnp.stack([pi0, piN, loc0, locN, n1, n2, z], axis=1)
        upd = lv & end
        loc0 = jnp.where(upd, loc, loc0)
        i0 = jnp.where(upd, t, i0)
        pi0 = jnp.where(upd, ps, pi0)
        n1 = jnp.where(lv, jnp.where(end, z, n1) + one.astype(jnp.uint32),
                       n1)
        n2 = jnp.where(lv, jnp.where(end, z, n2)
                       + (~one).astype(jnp.uint32), n2)
        locN = jnp.where(lv, loc, locN)
        piN = jnp.where(lv, ps, piN)
        iN = jnp.where(lv, t, iN)
        return (loc0, locN, pi0, piN, i0, iN, n1, n2), (emit, rec)

    # i0/iN are the SEED ORDINAL within the read (the reference indexes
    # the whole per-read seed array incl. dead seeds, modmap.c:216)
    ords = jnp.broadcast_to(jnp.arange(S, dtype=jnp.uint32)[None, :],
                            (R, S))
    init = (z,) * 8
    xs = (loc_a.T, loc_b.T, id_a.T, id_b.T, is1.T, live.T, pos.T, ords.T)
    (loc0, locN, pi0, piN, i0, iN, n1, n2), (emits, recs) = \
        jax.lax.scan(step2, init, xs)
    # final block: gated on n2 > 2 alone (modmap.c:269, quirk)
    fin_emit = n2 > 2
    fin_rec = jnp.stack([pi0, piN, loc0, locN, n1, n2,
                         jnp.ones(R, jnp.uint32)], axis=1)
    emits = jnp.concatenate([emits, fin_emit[None]], axis=0)   # [S+1, R]
    recs = jnp.concatenate([recs, fin_rec[None]], axis=0)      # [S+1, R, F]

    # per-read emit-rank one-hot compaction, int8/s32 exact over 8-bit limbs
    SP = S + 1
    e = emits.T                                                # [R, SP]
    eint = e.astype(jnp.int32)
    csum = jnp.cumsum(eint, axis=1)
    dest = jnp.where(e, csum - 1, -1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (R, cap, SP), 1)
    onehot = (dest[:, None, :] == slots).astype(jnp.int8)
    r = recs.transpose(1, 0, 2)                                # [R, SP, F]
    limbs = [(r >> jnp.uint32(sh)) & jnp.uint32(0xFF)
             for sh in (24, 16, 8, 0)]
    cols = (jnp.concatenate(limbs, axis=2).astype(jnp.int32)
            - 128).astype(jnp.int8)                            # [R, SP, 4F]
    o = jax.lax.dot_general(onehot, cols, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.int32)
    counts = csum[:, -1]
    live_slot = (jax.lax.broadcasted_iota(jnp.int32, (R, cap), 1)
                 < counts[:, None])
    ou = jnp.where(live_slot[:, :, None], (o + 128).astype(jnp.uint32), 0)
    out = ((ou[:, :, 0:F] << jnp.uint32(24))
           | (ou[:, :, F:2 * F] << jnp.uint32(16))
           | (ou[:, :, 2 * F:3 * F] << jnp.uint32(8))
           | ou[:, :, 3 * F:4 * F])
    out = jnp.where(live_slot[:, :, None], out, jnp.uint32(0xFFFFFFFF))
    return out, counts, jnp.any(counts > cap)


def chain_records(ref, sidx, spos, seed_off, cap=8, tile_reads=4096):
    """Host driver: bucket reads into padded tiles, run chain_scan, return
    per-read M records [(pos_i0, pos_iN, loc0, locN, n1, n2, is_final)] in
    emission order — the exact rows mm_query_emit would print as M lines.

    ref: core.reference.Reference (rev/loc/id arrays + modset info)."""
    info = ref.ms.info
    n_reads = len(seed_off) - 1
    out = [[] for _ in range(n_reads)]
    copy = info[sidx] & 3
    live_all = (sidx != 0) & (copy != 3)
    la_all = np.where(sidx != 0, ref.rev[ref.loc[sidx]], 0).astype(np.uint32)
    lb_idx = np.where((sidx != 0) & (copy == 2), ref.loc[sidx] + 1, 0)
    lb_all = ref.rev[lb_idx].astype(np.uint32)
    ida_all = ref.id[la_all].astype(np.uint32)
    idb_all = ref.id[lb_all].astype(np.uint32)
    idmap = np.ascontiguousarray(ref.id, np.uint32)
    import jax.numpy as jnp
    idmap_d = jnp.asarray(idmap)
    counts = np.diff(seed_off)
    order = np.argsort(counts, kind="stable")
    for t0 in range(0, n_reads, tile_reads):
        rids = order[t0:t0 + tile_reads]
        # pad S to a power of two and R to the full tile: one XLA shape
        # per (S bucket, cap) across the whole run (compiles through the
        # remote service cost seconds-to-minutes each)
        S = max(8, 1 << (int(counts[rids].max()) - 1).bit_length())
        R = tile_reads
        la = np.zeros((R, S), np.uint32)
        lb = np.zeros((R, S), np.uint32)
        ia = np.zeros((R, S), np.uint32)
        ib = np.zeros((R, S), np.uint32)
        on = np.zeros((R, S), bool)
        lv = np.zeros((R, S), bool)
        ps = np.zeros((R, S), np.uint32)
        for j, rd in enumerate(rids):
            a, b = seed_off[rd], seed_off[rd + 1]
            m = b - a
            la[j, :m] = la_all[a:b]
            lb[j, :m] = lb_all[a:b]
            ia[j, :m] = ida_all[a:b]
            ib[j, :m] = idb_all[a:b]
            on[j, :m] = copy[a:b] == 1
            lv[j, :m] = live_all[a:b]
            ps[j, :m] = spos[a:b]
        c = cap
        while True:
            rec, cnt, ovf = chain_scan(
                jnp.asarray(la), jnp.asarray(lb), jnp.asarray(ia),
                jnp.asarray(ib), jnp.asarray(on), jnp.asarray(lv),
                jnp.asarray(ps), idmap_d, cap=c)
            if not bool(np.asarray(ovf)):
                break
            c *= 2
        rec = np.asarray(rec)
        cnt = np.asarray(cnt)
        for j, rd in enumerate(rids):
            out[rd] = [tuple(rec[j, s]) for s in range(cnt[j])]
    return out
