"""The launch geometries of kernel 2 (the dynamics chain), in pure Python.

``rk.chain_geometry`` picks one rollout a warp for the nominal trajectory
(K = 1) and small K, one rollout a thread beyond; ``rk.chain_store_slots``
says, as the kernels compute it, which thread stores which of a rollout's
nine outputs (seven states, two controls) every step.  Each output of each
rollout of the launch's slice is stored by exactly one thread, at ragged K
and any k_offset; a dummy rollout past K repeats rollout K - 1 and stores
nothing; a warp leaves only as a whole.  Also the BF warp form's table of
basis functions, one a lane, against BfDeriv's own arithmetic, bit for
bit."""

import re
from pathlib import Path

import numpy as np
import pytest

from autorally_tpu_torch.ops import rollout_kernel as rk

H100_SMS = 132


def _check_chain_slots(geom, K, k_offset):
    k, stores = rk.chain_store_slots(geom, K, k_offset)
    assert k.shape == (geom.grid, geom.block)
    assert stores.shape == (geom.grid, geom.block, rk.CHAIN_OUTPUTS)
    # every (rollout, output) pair of the slice exactly once
    kk = np.broadcast_to(k[..., None], stores.shape)[stores]
    out = np.broadcast_to(np.arange(rk.CHAIN_OUTPUTS), stores.shape)[stores]
    pairs = np.sort(kk * rk.CHAIN_OUTPUTS + out)
    want = (np.arange(k_offset, k_offset + K)[:, None] * rk.CHAIN_OUTPUTS
            + np.arange(rk.CHAIN_OUTPUTS)).reshape(-1)
    np.testing.assert_array_equal(pairs, want)
    # the threads that run, run a rollout of the slice (dummies: K - 1)
    ran = k[k >= 0]
    assert ran.min() >= k_offset and ran.max() < k_offset + K
    if geom.group > 1:
        left = (k < 0).reshape(geom.grid, geom.block // 32, 32)
        assert np.all(left.all(axis=2) == left.any(axis=2))
        g = k.reshape(geom.grid, -1, geom.group)
        assert np.all(g == g[..., :1])
        # a lane stores at most one output, lanes 0..8 of a real rollout
        assert stores.sum(axis=2).max() <= 1
        lane = np.arange(geom.block) % 32
        assert not stores[:, lane >= rk.CHAIN_OUTPUTS].any()


@pytest.mark.parametrize("k_offset", [0, 131003])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 31, 33, 127, 1919, 1920, 1921,
                               2560, 2561, 4225])
@pytest.mark.parametrize("forced", rk.CHAIN_GEOMETRIES,
                         ids=lambda f: "G%dB%d" % f)
def test_every_chain_geometry_stores_each_output_once(forced, K, k_offset):
    """Every geometry kernel 2 takes, at ragged K: each state and control
    of each rollout of the slice is stored by exactly one thread, dummy
    rollouts repeat rollout K - 1 and store nothing, whole warps leave."""
    _check_chain_slots(rk._geometry(K, *forced), K, k_offset)


@pytest.mark.parametrize("bf", [False, True])
@pytest.mark.parametrize("K", [1, 5, 1920, 2560, 65536, 262144])
def test_chain_geometry_is_one_the_kernel_takes(K, bf):
    """The launcher's pick on an H100 (132 SMs): a built geometry
    (``rk.CHAIN_GEOMETRIES``) covering every output of every rollout, and
    one rollout a warp for the nominal trajectory (K = 1) in both models."""
    geom = rk.chain_geometry(K, H100_SMS, bf)
    assert geom[:2] in rk.CHAIN_GEOMETRIES
    assert geom.grid == -(-K // (geom.block // geom.group))
    if K == 1:
        assert geom[:2] == (32, rk.CHAIN_WARP_BLOCK)
    if K >= 65536:
        assert geom.group == 1
    _check_chain_slots(geom, K, 69)


def test_chain_geometry_follows_the_sm_count():
    """The warp form up to ``CHAIN_WARP_ROLLOUTS_PER_SM`` rollouts an SM,
    one rollout a thread past it, for each model."""
    for bf, per_sm in rk.CHAIN_WARP_ROLLOUTS_PER_SM.items():
        for sms in (1, 66, H100_SMS):
            assert rk.chain_geometry(per_sm * sms, sms, bf).group == 32
            assert rk.chain_geometry(per_sm * sms + 1, sms, bf).group == 1


# -- the warp form's basis functions, one a lane (csrc BfWarpDeriv) ---------

def _source_table(name, conv):
    """The initializer of the ``__constant__`` array ``name`` in the kernel
    source, 32 entries (missing ones 0)."""
    src = (Path(rk.__file__).parent.parent / "csrc"
           / "rollout_kernels.cu").read_text()
    body = re.search(rf"{name}\[32\] = \{{(.*?)\}};", src, re.S).group(1)
    vals = [conv(v.strip()) for v in body.split(",") if v.strip()]
    return vals + [conv("0")] * (32 - len(vals))


def _bf_phi_one_thread(roll, ux, uy, yd, u0, u1):
    """BfDeriv's 25 basis functions, float32, one rounding an operation in
    the source's order (its tanf/atanf/sinf: numpy's, the same for both)."""
    f = np.float32
    moving = ux > f(0.1)
    sux = np.where(moving, ux, f(1))
    q1 = uy / sux
    front = np.arctan(q1 + f(0.45) * yd / sux).astype(f) - u0
    tf = np.tan(np.where(moving, front, -u0)).astype(f)
    atf, tf3 = np.abs(tf), tf * tf * tf
    ss = np.sin(u0).astype(f)
    r13 = uy / sux - f(0.35) * yd / sux
    z = np.zeros_like(ux)
    return np.stack([
        u1, ux / f(10), ss * tf / f(1200), ss * tf * atf / f(1440000),
        ss * tf3 / f(1728000000), yd * uy / f(25), yd / f(10), uy / f(10), ss,
        np.where(moving, uy / sux / f(40), z), tf / f(1400),
        tf * atf / f(1960000), tf3 / f(2744000000),
        np.where(moving, r13 / f(40), z),
        np.where(moving, r13 * np.abs(r13) / f(1600), z),
        np.where(moving, r13 * r13 * r13 / f(64000), z), yd * ux / f(50),
        roll, roll * yd, roll * ux / f(3), roll * ux * yd / f(5),
        ux * ux / f(100), ux * ux * ux / f(1000), u1 * u1, u1 * u1 * u1])


def test_bf_warp_basis_table_gives_the_one_thread_bits():
    """Each lane's phi_i = ((v[a] v[b]) v[c]) / d from the source's tables
    (``c_bf_ops``, ``c_bf_div``) equals BfDeriv's phi_i bit for bit, in
    float32 with one rounding an operation, moving and not, and is zeroed
    where BfDeriv zeroes it."""
    f = np.float32
    ops = _source_table("c_bf_ops", lambda v: int(v, 0))
    div = _source_table("c_bf_div", lambda v: f(float(v.rstrip("f"))))
    rs = np.random.default_rng(7)
    n = 20000
    roll, uy, yd, u0, u1 = (rs.normal(0, s, n).astype(f)
                            for s in (0.1, 1.0, 1.5, 0.4, 0.6))
    ux = rs.uniform(-1, 12, n).astype(f)
    ux[:50] = f(0.1)                        # the moving test's edge
    with np.errstate(all="ignore"):
        want = _bf_phi_one_thread(roll, ux, uy, yd, u0, u1)
        moving = ux > f(0.1)
        sux = np.where(moving, ux, f(1))
        q1 = uy / sux
        tf = np.tan(np.where(moving, np.arctan(q1 + f(0.45) * yd / sux)
                             .astype(f) - u0, -u0)).astype(f)
        r13 = q1 - f(0.35) * yd / sux
        v = [np.ones_like(ux), u1, ux, uy, yd, roll, np.sin(u0).astype(f),
             tf, np.abs(tf), tf * tf * tf, q1, r13, np.abs(r13)]
        for i in range(25):
            a, b, c, gated = (ops[i] & 15, ops[i] >> 4 & 15, ops[i] >> 8 & 15,
                              ops[i] >> 12)
            got = v[a] * v[b] * v[c] / div[i]
            if gated:
                got = np.where(moving, got, f(0))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want[i].view(np.int32), str(i))
    # the lanes past the 25 basis functions form 1 and are never read
    assert all(o == 0 for o in ops[25:]) and all(d == 1 for d in div[25:])


# -- kernel 2's latency floor, counted from its SASS (tools/sass_chain) -----

_SASS = """
        Function : _Z3foov
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R8, [R1] ;
        /*0020*/                   FFMA R2, R2, R9, R4 ;
        /*0030*/                   MUFU.EX2 R5, R2 ;
        /*0040*/              @!P0 BRA 0x60 ;
        /*0050*/                   MUFU.RCP R5, R5 ;
        /*0060*/                   SHFL.IDX PT, R7, R5, RZ, 0x1f ;
        /*0070*/                   FFMA R2, R7, R11, R2 ;
        /*0080*/                   ISETP.NE.AND P0, PT, R6, RZ, PT ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   EXIT ;
        ..........
        Function : _Z3barv
        /*0000*/                   EXIT ;
        ..........
        Function : _Z3bazv
        /*0000*/                   FFMA R2, R2, R3, R4 ;
        /*0010*/                   STG.E [R6.64], R2 ;
        /*0020*/                   FFMA R2, R2, R3, R4 ;
        /*0030*/                   STG.E [R6.64+0x4], R2 ;
        /*0040*/               @P0 BRA 0x0 ;
        /*0050*/                   EXIT ;
"""


def test_sass_chain_follows_the_loop_carried_registers():
    """One pass of the time loop (the backward branch's span): R2 is
    carried through FFMA (4) -> MUFU (20) -> SHFL (25) -> FFMA (4); the
    slow path behind the forward branch is left out; a vector load's
    registers are its four; the loop's other instructions are counted."""
    from autorally_tpu_torch.tools import sass_chain

    ins = sass_chain.instructions(_SASS, r"_Z3foov")
    assert len(ins) == 11 and ins[1][2:4] == ("LDS", ".128")
    assert sass_chain._dests_sources("LDS", ".128", "R8, [R1]") == (
        ["R8", "R9", "R10", "R11"], ["R1"])
    assert sass_chain._dests_sources("SHFL", ".IDX", "PT, R7, R5, RZ, 0x1f") \
        == (["R7"], ["R5"])
    got = sass_chain.loop_chain(ins)
    assert got == {"cycles": 53, "chain": 4, "in_order": 49, "body": 7,
                   "skipped": 1, "stores": 0}
    with pytest.raises(ValueError):
        sass_chain.loop_chain(sass_chain.instructions(_SASS, r"_Z3barv"))


def test_sass_chain_refuses_a_loop_body_of_more_than_one_step():
    """A time loop that ptxas unrolled twice holds two steps' stores: given
    one step's, ``loop_chain`` refuses it, since T times its chain would
    count each step twice; given two, it counts the pass."""
    from autorally_tpu_torch.tools import sass_chain

    ins = sass_chain.instructions(_SASS, r"_Z3bazv")
    with pytest.raises(ValueError, match="2 STG, not the 1"):
        sass_chain.loop_chain(ins, stores=1)
    got = sass_chain.loop_chain(ins, stores=2)
    assert got["stores"] == 2 and got["cycles"] == 8 and got["chain"] == 2


def _stream_sass(steps: int, tail: int) -> str:
    """A kernel whose time loop holds ``steps`` steps of a stand-in stream
    (20 rotations, 10 integer adds, 5 FMUL a step) and, behind a forward
    branch, ``tail`` more integer instructions."""
    body = (["SHF.L.W.U32.HI R2, R3, 0xd, R3 ;", "IADD3 R4, R2, R5, RZ ;"]
            * 10 + ["SHF.L.W.U32.HI R2, R3, 0xf, R3 ;"] * 10
            + ["FMUL R6, R6, R7 ;"] * 5) * steps
    n = len(body)
    lines = ["MOV R1, c[0x0][0x28] ;", f"@P1 BRA 0x{16 * (n + 3 + tail):x} ;"]
    lines += body + ["LOP3.LUT R8, R8, R9, RZ, 0x3c, !PT ;"] * tail
    lines += ["@P0 BRA 0x10 ;", "EXIT ;"]
    return "\n        Function : _Z3quxv\n" + "\n".join(
        f"        /*{16 * i:04x}*/                   {ins}"
        for i, ins in enumerate(lines))


@pytest.mark.parametrize("steps", [1, 4])
def test_loop_mix_counts_a_step_of_the_stream(steps):
    """``loop_mix`` takes the loop with the stream's rotations, divides it
    into steps (20 rotations each), counts a step's instructions and
    integer ones, and apart those behind a forward branch; ``pipe_bounds``
    turns a step into floors (64 INT32 lanes, 4 warp instructions a clock
    an SM)."""
    from autorally_tpu_torch.tools import sass_chain

    ins = sass_chain.instructions(_stream_sass(steps, 8), r"_Z3quxv")
    mix = sass_chain.loop_mix(ins)
    n = 35 * steps + 8 + 1 + 1       # body, tail, the branch over it, loop
    assert mix["steps"] == steps
    assert mix["instructions"] == n / steps
    assert mix["int"] == (30 * steps + 8) / steps
    assert mix["instructions_always"] == 2 / steps and mix["int_always"] == 0
    floors = sass_chain.pipe_bounds(mix, 64 * 132, 1980, 132, 1980.0,
                                    branched=True)
    assert floors["int_ms"] == pytest.approx(mix["int"] * 1e-3)
    assert floors["issue_ms"] == pytest.approx(
        mix["instructions"] * 64 * 132 / 32 * 1980 / (4 * 132 * 1980e3))
    with pytest.raises(ValueError, match="no loop holds a step"):
        sass_chain.loop_mix(sass_chain.instructions(_SASS, r"_Z3foov"))
