"""The plan and block partition of ``csrc/lb_core.cuh``: the attention
core's backward above window 16 in bf16 (B9's large family, entry
``attn_bwd_large_mma_bf16``, and B13's, ``oca_core_bwd_large_mma_bf16``).

Plain Python, no card: the CPU tests hold the kernels' partition to its
rules with it, and the wrappers (``attn_bwd.large_partition``,
``oca_core.large_partition``) expose it. Change it with ``lb_plan``,
``lb_main_rest`` and the kernels' loops together.

On a unit (window w, head h) of ``qt`` query tiles and ``kt`` key chunks of
64 tokens:

* pass 1 (``lb_stats_kernel``), a block a (unit, pair of query tiles), forms
  each (w, h, r, c) once, over the chunks in order: the row statistics;
* pass 2 (``lb_main_kernel``), for each batch of ``WB`` windows and each
  run of ``PB`` query parts (all of them unless one window's dq partials
  pass the cap) a block a (group g, head h, query part p, key chunk c),
  forms each (w, h, r, c) of its part once, windows g, g + G, ... of the
  batch, tiles 2 i + wg of the part by warpgroup wg: d bias into the
  block's slab, taken up from group g's slab after the first batch and put
  back, dq's partial of the chunk, dk and dv of the chunk summed over the
  part's tiles (warpgroup 0's, then 1's);
* pass 3: dq of (w, h, r) is its chunks' partials in chunk order, dk / dv of
  (w, h, c) its parts' in part order (one part: pass 2 stores them), d bias
  (h, q, k) the groups' slabs in group order.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["SMEM", "DQP_FLOATS", "MAX_GROUPS", "Plan", "qmax", "plan", "partition"]

TOK = 64
SMEM = 232448  # a block's most shared memory on the H100 (LB_SMEM)
DQP_FLOATS = 64 << 20  # dq partials a batch (LB_DQP_FLOATS)
MAX_GROUPS = 32  # LB_MAX_GROUPS


class Plan(NamedTuple):
    heads: int
    qt: int
    kt: int
    dp: int
    qmax: int
    parts: int
    pb: int
    groups: int
    wb: int
    batches: int
    windows: int
    stats_elems: int
    dqp_elems: int
    kvp_elems: int
    dbp_elems: int

    @property
    def f_elems(self) -> int:
        return self.stats_elems + self.dqp_elems + self.kvp_elems + self.dbp_elems


def main_rest(dp: int) -> int:
    """Pass 2's shared memory without the slab (``lb_main_rest``)."""
    ch = TOK * dp * 2
    return 3 * ch + 2 * (4 * ch + 2 * TOK * TOK * 2 + TOK * 3 * 4) + TOK


def qmax(dp: int) -> int:
    """The query tiles a block's d-bias slab holds (``lb_qmax``): 9 at DP 32."""
    return (SMEM - main_rest(dp)) // (TOK * TOK * 4)


def plan(windows: int, heads: int, qt: int, kt: int, dp: int, sms: int = 132) -> Plan:
    """``lb_plan`` and the f32 scratch it sizes (``lb_f_elems``)."""
    q = qmax(dp)
    parts = pb = -(-qt // q)
    per = heads * qt * kt * TOK * dp
    if per > DQP_FLOATS:  # one window a batch, its parts in runs
        runs = -(-parts // max(1, DQP_FLOATS // (heads * q * kt * TOK * dp)))
        pb = -(-parts // runs)
    batches = -(-windows // max(1, min(windows, DQP_FLOATS // per)))
    wb = -(-windows // batches)
    best, groups = None, 1
    for g in range(1, min(wb // 8, MAX_GROUPS) + 1):
        cost = -(-(g * heads * kt * pb) // sms) * -(-wb // g)
        if best is None or cost < best:
            best, groups = cost, g
    return Plan(heads, qt, kt, dp, q, parts, pb, groups, wb, batches, windows,
                stats_elems=windows * heads * qt * TOK * 3, dqp_elems=wb * heads * min(qt, pb * q) * kt * TOK * dp,
                kvp_elems=wb * heads * kt * parts * 2 * TOK * dp if parts > 1 else 0,
                dbp_elems=groups * heads * qt * TOK * kt * TOK)


def partition(windows: int, heads: int, qt: int, kt: int, dp: int, sms: int = 132) -> dict:
    """The work of each block of passes 1 and 2, in launch order, and the
    sums of pass 3, as the kernels take them:

    * ``stats``: per block of pass 1, the (w, h, r, c) it forms, in order;
    * ``main``: per (batch, run, block) of pass 2, ((batch, g, h, part, c),
      the (w, h, r, c) it forms in order);
    * ``dq``: (w, h, r) -> the chunks whose partials it sums, in order;
    * ``dkdv``: (w, h, c) -> the (batch, g, part) blocks whose sums it takes,
      in order (one: the block stores them);
    * ``dbias``: (h, query tile, key chunk) -> the slabs it sums, in group
      order, each (g, the windows added into it, in order);
    * ``runs``: per batch, the (p0, p1) part runs of its launches."""
    p = plan(windows, heads, qt, kt, dp, sms)
    stats = []  # the two warpgroups of a block take its chunks in lockstep
    for u in range(windows * heads):
        w, h = divmod(u, heads)
        for pair in range((qt + 1) // 2):
            stats.append([(w, h, r, c) for c in range(kt) for r in (2 * pair, 2 * pair + 1) if r < qt])
    main, dkdv, slabs, runs = [], {}, {}, []
    for b in range(p.batches):
        w0, w1 = b * p.wb, min(windows, (b + 1) * p.wb)
        runs.append([(p0, min(p.parts, p0 + p.pb)) for p0 in range(0, p.parts, p.pb)])
        for p0, p1 in runs[-1]:
            for blk in range(p.groups * heads * (p1 - p0) * kt):
                c, rest = blk % kt, blk // kt
                part, rest = p0 + rest % (p1 - p0), rest // (p1 - p0)
                h, g = rest % heads, rest // heads
                r0 = part * p.qmax
                qtb = min(p.qmax, qt - r0)
                work = []
                for w in range(w0 + g, w1, p.groups):
                    for i in range((qtb + 1) // 2):
                        work += [(w, h, r0 + lr, c) for lr in (2 * i, 2 * i + 1) if lr < qtb]
                    dkdv.setdefault((w, h, c), []).append((b, g, part))
                    for lr in range(qtb):  # the slab of (g, h) takes up where the last batch left it
                        slabs.setdefault((h, r0 + lr, c), {}).setdefault(g, []).append(w)
                main.append(((b, g, h, part, c), work))
    dbias = {key: sorted(by_group.items()) for key, by_group in slabs.items()}
    dq = {(w, h, r): list(range(kt)) for w in range(windows) for h in range(heads) for r in range(qt)}
    return {"plan": p, "stats": stats, "main": main, "dq": dq, "dkdv": dkdv, "dbias": dbias, "runs": runs}

