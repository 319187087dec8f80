"""The work of the RGB-uv histogram operation, counted from (B, N, bins)
whatever implements it, and the least time the card could take for it.

Per (pixel, plane, bin) triple: the forward is one product of the
intensity-weighted u kernel with the v kernel, 2 * bins FLOP, and the
backward two, 4 * bins FLOP. They run against the TF32 dense tensor-core
peak, the fastest product on the card that can meet the operation's 1e-5
gate, so no implementation reads over its bound. Elementwise work (the
kernels' plain formulas): 11 fp32 operations a triple forward (u and v
kernels 5 each, the intensity weight 1) and 26 backward (the kernels
again, and the epilogue's slopes and sums), against the fp32 peak. Bytes:
the packed pixels (8 floats) and the histogram, each read or written
once; the backward reads the packed pixels and the histogram's gradient
and writes the pixels' gradient."""

from __future__ import annotations

from benchmark.work.peaks import FP32_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS

PLANES = 3


def hist_work(direction: str, batch: int, n_pixels: int, bins: int = 64) -> dict:
    """{'flop', 'elementwise', 'bytes'} of one call; ``direction`` is
    'fwd' or 'bwd'."""
    triples = PLANES * batch * n_pixels * bins
    packed = batch * n_pixels * 8 * 4
    hist = batch * PLANES * bins * bins * 4
    if direction == "fwd":
        return {"flop": 2 * bins * triples, "elementwise": 11 * triples, "bytes": packed + hist}
    if direction == "bwd":
        return {"flop": 4 * bins * triples, "elementwise": 26 * triples,
                "bytes": 2 * packed + hist}
    raise ValueError(direction)


def bound_s(work: dict) -> float:
    """The least seconds the card could take for ``work``: the largest of
    the products over the TF32 peak, the elementwise operations over the
    fp32 peak and the bytes over the memory's rate."""
    return max(work["flop"] / TF32_FLOPS, work["elementwise"] / FP32_FLOPS,
               work["bytes"] / HBM_BYTES_PER_S)


def roofline_share(direction: str, calls, bins: int = 64):
    """The summed bound time of ``calls`` [(B, N, device seconds)], the
    calls of one direction that a profile holds, over their summed device
    time, in %; None when there is no call, no time, or a call of unknown
    shape (see ``trace.TraceView._hist_calls`` for how kernels are tied to
    calls)."""
    spent = sum(t for _, _, t in calls)
    if not calls or spent <= 0 or any(b == 0 for b, _, _ in calls):
        return None
    return 100.0 * sum(bound_s(hist_work(direction, b, n, bins)) for b, n, _ in calls) / spent
