"""A roofline count of the whole-exposure readout kernel (B1) from its own
inputs: the least time the H100 could take for the bytes it moves and the
operations its data needs.

Frozen copy of ``chip_smoke.py``'s ``COSTS``, ``_bound``, ``_read_work``,
``_add_band_work``, ``_add_exact_work`` and ``bound_of`` at commit a57e3cf
(the first two slices' ``OLD_*`` yardstick left out). Bytes: each input
read and each output written once at 3.35 TB/s. Operations: 32-bit
integer work on two pipes of 64 lanes per clock per SM, all issue at 128,
132 SMs at 1.98 GHz; a transcendental counts as one operation, a floor.
"""

from __future__ import annotations

H100_BYTES_S = 3.35e12      # HBM3 rate (NVIDIA data sheet, H100 SXM)
H100_SMS, H100_CLOCK_HZ = 132, 1.98e9
IMAD_OPS_S = 64 * H100_SMS * H100_CLOCK_HZ      # 16.7e12
ALU_OPS_S = 64 * H100_SMS * H100_CLOCK_HZ       # 16.7e12
ISSUE_OPS_S = 128 * H100_SMS * H100_CLOCK_HZ    # 33.5e12
# (IMAD, ALU, other) operations of each piece of a pixel's read. A
# Philox4x32-10 block after the first of a kernel adds 42 SASS
# instructions: 20 IMAD.WIDE.U32 and an IMAD.SHL, 20 LOP3.LUT, one more.
COSTS = {
    "philox": (21, 20, 1),
    "box_muller": (0, 2, 14),
    "sampler": (0, 0, 12),
    "small_lam": (0, 1, 64),
    "readout": (0, 0, 16),
    "cr": (0, 0, 1),
    "knuth": (0, 1, 7),
    "ptrs": (0, 2, 44),
}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: int, work: dict) -> dict:
    """The least time (ms) for moving ``nbytes`` and doing ``work`` (how
    many of each piece of COSTS): the largest of the bytes over the memory
    rate, the IMAD and the ALU operations over their pipes' rates and all
    operations over the issue rate, and which of them binds."""
    n_imad, n_alu, n_other = (sum(n * COSTS[p][i] for p, n in work.items())
                              for i in range(3))
    t = dict(bytes_ms=nbytes / H100_BYTES_S * 1e3,
             imad_ms=n_imad / IMAD_OPS_S * 1e3,
             alu_ms=n_alu / ALU_OPS_S * 1e3,
             issue_ms=(n_imad + n_alu + n_other) / ISSUE_OPS_S * 1e3)
    t["ops_ms"] = max(t["imad_ms"], t["alu_ms"], t["issue_ms"])
    t["bound_term"] = max(("bytes", "imad", "alu", "issue"),
                          key=lambda term: t[term + "_ms"])
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    return t


def _read_work(lam, px_reads: int, cr_q, flags) -> dict:
    """How many of each piece of COSTS the background sampler, the normals
    and the readout chain of ``px_reads`` pixel-reads with background
    ``lam`` need, and ``cr_q``'s deposits."""
    work = dict(readout=px_reads, philox=0, box_muller=0, sampler=0,
                small_lam=0, knuth=0, ptrs=0,
                cr=0 if cr_q is None else int((cr_q != 0).sum()))
    n_normal = px_reads if flags["read_noise"] else 0
    if (flags["poisson"] and flags.get("bg_poisson", True)
            and flags.get("exact_poisson")):
        _add_exact_work(work, lam)
    elif flags["poisson"] and flags.get("bg_poisson", True):
        # a normal where lambda >= 3, a uniform and the exact sum where
        # 0 < lambda < 3, nothing where lambda = 0
        gauss = int((lam >= 3).sum())
        small = int(((lam > 0) & (lam < 3)).sum())
        if not flags["read_noise"]:
            n_normal = gauss
        work["sampler"] += gauss
        work["philox"] += small
        work["small_lam"] += small
    work["philox"] += n_normal
    work["box_muller"] += n_normal
    return work


def bound_of(args, flags) -> dict:
    """Least time for the whole-exposure readout on these inputs: bytes
    each input and output moves once, and the operations this run's data
    needs (see _bound). ``args``: the readout's (seed, y0s, dts, bands,
    bg_rate, bias_map, inv_gain, nl_coeffs, cr_pos, cr_q, consts)."""
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, _ = args
    B, NR, W, S = bands.shape
    nbytes = _nbytes(seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos,
                     cr_q) + (B * NR * S * S + B * S * S) * 4  # reads + cum
    work = _read_work(bg[:, None] * dts[:, :, None, None], B * NR * S * S,
                      cr_q if flags.get("with_cr", True) else None, flags)
    if flags["poisson"]:
        _add_band_work(work, bands, flags.get("exact_poisson", False))
    return _bound(nbytes, work)


def _add_exact_work(work: dict, lam) -> None:
    """Adds the least work of the exact sampler on ``lam``: below 10,
    Knuth's lam + 1 uniforms in max(1, (lam + 1) / 4) Philox blocks; from
    10, one PTRS attempt and its block; nothing where lambda = 0."""
    knuth = lam[(lam > 0) & (lam < 10)].double()
    n_ptrs = int((lam >= 10).sum())
    work["philox"] += float(((knuth + 1) / 4).clamp_min(1).sum()) + n_ptrs
    work["knuth"] += float((knuth + 1).sum())
    work["ptrs"] += n_ptrs


def _add_band_work(work: dict, bands, exact: bool = False) -> None:
    """Adds the in-kernel Poisson draw of the expected ``bands``: a Philox
    block, Box-Muller and the sampler where lambda >= 3, a Philox block
    and the exact sum where 0 < lambda < 3, nothing where lambda = 0; with
    ``exact`` the exact sampler's."""
    if exact:
        _add_exact_work(work, bands)
        return
    gauss = int((bands >= 3).sum())
    small = int(((bands > 0) & (bands < 3)).sum())
    for piece in ("philox", "box_muller", "sampler"):
        work[piece] += gauss
    work["philox"] += small
    work["small_lam"] += small
