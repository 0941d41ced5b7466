"""The least-time bounds that chip_smoke.py prints beside each kernel's
time, held against hand counts at a tiny shape.

One exposure, two reads (read 0 has zero entries; read 1 lasts 2 s), a 4 x 4
frame, a one-row band at row 1 and three hit slots per read. The bound
counts, for what these inputs need, each piece of ``COSTS``: a Philox block
and Box-Muller pair per normal, the sampler where lambda >= 3, a Philox
block and the exact sum where 0 < lambda < 3, nothing where lambda = 0, the
readout chain per pixel and read, one add per non-zero hit.
"""

import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)

S = 4
# bytes: seed 8, y0s 8, dts 8, bands 32, bg 64, bias 64, inv_gain 64, nl
# 192, cr_pos 48, cr_q 24, then reads 128 and cum 64 written
NBYTES = 704
ZERO_SMALL_GAUSS = (0.0, 0.5, 5.0, 5.0)   # bg columns: lambda 0, 1, 10, 10


def _args(bg_cols, band_row):
    bands = torch.zeros((1, 2, 1, S))
    bands[0, 1, 0] = torch.tensor(band_row)
    cr_q = torch.zeros((1, 2, 3))
    cr_q[0, 1] = torch.tensor([100.0, 0.0, 7.0])            # two deposits
    return (torch.zeros((1, 2), dtype=torch.int32),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([[0.0, 2.0]]), bands,
            torch.tensor(bg_cols).expand(1, S, S).contiguous(),
            torch.zeros((S, S)), torch.ones((S, S)), torch.zeros((3, S, S)),
            torch.zeros((1, 2, 2, 3), dtype=torch.int32), cr_q,
            (20.0, 78000.0, 2.5, 0.0))


def _expected(nbytes, work):
    n_imad, n_alu, n_other = (sum(n * cs.COSTS[p][i] for p, n in work.items())
                              for i in range(3))
    rate = 132 * 1.98e9                     # SMs x clock: lanes -> ops/s
    times = dict(bytes_ms=nbytes / 3.35e12 * 1e3,
                 imad_ms=n_imad / (64 * rate) * 1e3,
                 alu_ms=n_alu / (64 * rate) * 1e3,
                 issue_ms=(n_imad + n_alu + n_other) / (128 * rate) * 1e3)
    old_ms = sum(n * cs.OLD_OPS[p] for p, n in work.items()) / 67e12 * 1e3
    return dict(times, ops_ms=max(times["imad_ms"], times["alu_ms"],
                                  times["issue_ms"]),
                bound_term=max(times, key=times.get)[:-3],
                old_ops_ms=old_ms)


def _assert_bound(got, want):
    for key in ("bytes_ms", "imad_ms", "alu_ms", "issue_ms", "ops_ms"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["bound_term"] == want["bound_term"]
    for prefix, ops in (("", want["ops_ms"]), ("old_", want["old_ops_ms"])):
        assert got[prefix + "bound_ms"] == pytest.approx(
            max(want["bytes_ms"], ops), rel=1e-12)
        assert got[prefix + "bound_by"] == (
            "bytes" if want["bytes_ms"] >= ops else "operations")


# (bg columns, band row of read 1, flags, the pieces these inputs need)
CASES = {
    # 32 pixel-reads, all with a normal; read 1's background: 8 Gaussian,
    # 4 small (a Philox block and the exact sum each), 4 zero; the band:
    # 2 Gaussian (Philox, Box-Muller, sampler), 1 small, 1 zero
    "mixed, noise on": (ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0], cs.NOISE_ON,
                        dict(philox=32 + 4 + 3, box_muller=32 + 2,
                             sampler=8 + 2, small_lam=4 + 1, readout=32,
                             cr=2)),
    # no sampling, no normals: the readout chain and the deposits
    "mixed, noise off": (ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0],
                         dict(cs.NOISE_ON, poisson=False, read_noise=False),
                         dict(philox=0, box_muller=0, sampler=0, small_lam=0,
                              readout=32, cr=2)),
    # without read noise a normal is drawn only where lambda >= 3
    "mixed, Poisson only": (ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0],
                            dict(cs.NOISE_ON, read_noise=False),
                            dict(philox=8 + 4 + 3, box_muller=8 + 2,
                                 sampler=8 + 2, small_lam=4 + 1, readout=32,
                                 cr=2)),
    # every lambda of read 1 Gaussian, background and band
    "all Gaussian": ((5.0,) * 4, [50.0] * 4, cs.NOISE_ON,
                     dict(philox=32 + 4, box_muller=32 + 4, sampler=16 + 4,
                          small_lam=0, readout=32, cr=2)),
    # the hits are not deposited when cosmic rays are off
    "no cosmic rays": (ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0],
                       dict(cs.NOISE_ON, with_cr=False),
                       dict(philox=32 + 4 + 3, box_muller=32 + 2,
                            sampler=8 + 2, small_lam=4 + 1, readout=32,
                            cr=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_exposure_bound_matches_a_hand_count(case):
    bg_cols, band_row, flags, work = CASES[case]
    _assert_bound(cs.bound_of(_args(bg_cols, band_row), flags),
                  _expected(NBYTES, work))


def _step_kw(banded):
    """Read 1's keyword arguments for a per-read step, and their bytes:
    the banded step's expected band row [0, 2, 50, 50] and hits, or the
    full-frame step's add frame."""
    args = _args(ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0])
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, consts = args
    kw = dict(seed=seed, read=1, dt=dts[:, 1].contiguous(),
              cum=torch.zeros((1, S, S)), bg_rate=bg, bias_map=bias,
              inv_gain=inv_gain, nl_coeffs=nl, consts=consts)
    # seed 8, dt 4, cum 64, planes 64 + 64 + 64 + 192, cum out + dn 128
    nbytes = 8 + 4 + 64 + 64 + 64 + 64 + 192 + 128
    if banded:
        kw.update(y0=y0s[:, 1].contiguous(), band=bands[:, 1].contiguous(),
                  cr_pos=cr_pos[:, 1].contiguous(),
                  cr_q=cr_q[:, 1].contiguous())
        return kw, nbytes + 4 + 16 + 24 + 12
    kw["add"] = torch.zeros((1, S, S))
    return kw, nbytes + 64


@pytest.mark.parametrize("banded", [True, False])
def test_step_bound_matches_a_hand_count(banded):
    """One read (read 1) of the per-read steps: 16 pixels, each with a
    normal; background 8 Gaussian, 4 small, 4 zero. The banded step draws
    its expected band in the kernel: 2 Gaussian values (Philox, Box-Muller,
    sampler), 1 small (Philox, the exact sum), 1 zero; the full-frame
    step's add frame comes sampled, so none of its sampling counts."""
    kw, nbytes = _step_kw(banded)
    work = dict(philox=16 + 4, box_muller=16, sampler=8, small_lam=4,
                readout=16, cr=0)
    if banded:
        for piece, n in (("philox", 2 + 1), ("box_muller", 2),
                         ("sampler", 2), ("small_lam", 1), ("cr", 2)):
            work[piece] += n
        flags = cs.NOISE_ON
    else:
        flags = {k: v for k, v in cs.NOISE_ON.items()
                 if k not in ("with_cr", "ipc")}
    _assert_bound(cs.step_bound_of(kw, flags), _expected(nbytes, work))


@pytest.mark.parametrize("read_noise", [False, True])
def test_banded_step_bound_without_poisson_adds_the_band_as_given(
        read_noise):
    """With Poisson off the banded step adds its band as given: neither
    the band nor the background is sampled, and normals are drawn only for
    the read noise."""
    kw, nbytes = _step_kw(True)
    flags = dict(cs.NOISE_ON, poisson=False, read_noise=read_noise)
    n = 16 if read_noise else 0
    work = dict(philox=n, box_muller=n, sampler=0, small_lam=0, readout=16,
                cr=2)
    _assert_bound(cs.step_bound_of(kw, flags), _expected(nbytes, work))


def test_the_integer_pipe_binds_philox_heavy_work():
    """Philox is integer work on two pipes, each at half the issue rate:
    IMAD (21 per block) on the FMA-heavy pipe, LOP3 (20) on the ALU. Its
    IMADs alone take as long as issuing its 42 instructions, so Philox
    alone is bound by the IMAD pipe, level with the issue rate. With the
    sampler and the readout chain around it (the noise-on readout) the
    issue of all operations binds. The first slices' yardstick (every
    operation at 67 T/s) counts less time for the same work."""
    philox = cs._bound(0, {"philox": 1000})
    assert philox["bound_term"] == "imad"
    assert philox["imad_ms"] == philox["issue_ms"] > philox["alu_ms"]
    work = CASES["mixed, noise on"][3]
    got = cs.bound_of(_args(ZERO_SMALL_GAUSS, [0.0, 2.0, 50.0, 50.0]),
                      cs.NOISE_ON)
    assert got["ops_ms"] == got["issue_ms"] > max(got["imad_ms"],
                                                  got["alu_ms"])
    assert _expected(NBYTES, work)["old_ops_ms"] < got["ops_ms"]


@pytest.mark.parametrize("bg_cols, band_row, share", [
    # read 1: every row holds a small-lambda background pixel (column 1)
    (ZERO_SMALL_GAUSS, [0.0, 0.0, 50.0, 50.0], 4 / 8),
    # read 1: only the band's row holds a small lambda
    ((5.0,) * 4, [50.0, 2.0, 50.0, 50.0], 1 / 8),
    # none: lambda is 0 or Gaussian everywhere
    ((0.0, 5.0, 5.0, 5.0), [0.0, 50.0, 50.0, 50.0], 0.0),
])
def test_small_lambda_warp_share(bg_cols, band_row, share):
    """Each row of the 4-pixel frame is one warp (padded to 32 lanes); two
    reads of four rows are 8 warp-reads, and read 0 is all zero."""
    assert cs.small_lambda_warp_share(_args(bg_cols, band_row)) == share


# Two functions of a cuobjdump -sass listing, with predicated and NOP
# instructions and encoding lines.
LISTING = """
        Function : philox_2
        /*0000*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
                                                         /* 0x000fe200078e00ff */
        /*0010*/                   LOP3.LUT R4, R3, R5, R6, 0x96, !PT ;
        /*0020*/                   IMAD.SHL.U32 R3, R9, 0x4, RZ ;
        /*0030*/              @!P0 BRA 0x50 ;
        /*0040*/                   NOP ;
        /*0050*/                   EXIT ;
        Function : philox_1
        /*0000*/                   LOP3.LUT R4, R3, R5, R6, 0x96, !PT ;
        /*0010*/                   EXIT ;
"""


PTXAS_LOG = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123read_step_banded_kernelENS_8StepArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123read_step_banded_kernelENS_8StepArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116read_step_kernelENS_8StepArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116read_step_kernelENS_8StepArgsE
    32 bytes stack frame, 28 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 40 registers, 544 bytes cmem[0]
"""


# the two instantiations of a kernel (template <bool EXACT>), each followed
# by the properties of an out-of-line device function it calls
PTXAS_LOG_TEMPLATES = """
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f4_12_read_step_cu_f5123read_step_banded_kernelILb0EEEvNS_8StepArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f4_12_read_step_cu_f5123read_step_banded_kernelILb0EEEvNS_8StepArgsE
    96 bytes stack frame, 64 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 96 bytes cumulative stack size, 8224 bytes smem
ptxas info    : Function properties for _ZN43_INTERNAL_f4_12_read_step_cu_f513add_band_callILb0EEEfffbjjjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f4_12_read_step_cu_f5123read_step_banded_kernelILb1EEEvNS_8StepArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f4_12_read_step_cu_f5123read_step_banded_kernelILb1EEEvNS_8StepArgsE
    184 bytes stack frame, 288 bytes spill stores, 156 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 184 bytes cumulative stack size, 8224 bytes smem
ptxas info    : Function properties for _ZN43_INTERNAL_f4_12_read_step_cu_f5120exact_poisson_sampleEfjjjjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


@pytest.mark.parametrize("log,want", [
    (PTXAS_LOG, {"read_step_banded_kernel": {
        "registers": 64, "spill_stores": 0, "spill_loads": 0},
        "read_step_kernel": {"registers": 40, "spill_stores": 28,
                             "spill_loads": 24}}),
    (PTXAS_LOG_TEMPLATES, {"read_step_banded_kernel": {
        "registers": 64, "spill_stores": 64, "spill_loads": 40},
        "read_step_banded_kernel (exact_poisson)": {
            "registers": 64, "spill_stores": 288, "spill_loads": 156}}),
], ids=["kernels", "instantiations and device functions"])
def test_registers_and_spills_of_a_ptxas_log(log, want):
    import torch_perf_breakdown as tpb

    assert tpb.parse_ptxas(log) == want


def test_opcode_counts_of_a_sass_listing():
    import torch_perf_breakdown as tpb

    ops = tpb.opcode_counts(LISTING)
    assert ops == {"philox_2": {"IMAD": 2, "LOP3": 1, "BRA": 1, "EXIT": 1},
                   "philox_1": {"LOP3": 1, "EXIT": 1}}
