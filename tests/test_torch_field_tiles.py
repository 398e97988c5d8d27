"""The field kernels' tensor-core layout, on the CPU.

The CUDA field kernels (``csrc/rollout_kernels.cu``, ``FieldLookup``)
evaluate the 34-64-64-1 field's two hidden layers with ``mma.sync``
m16n8k8 TF32 in 3xTF32: each operand x split into hi = tf32(x) and lo =
tf32(x - hi), each product taken as lo hi + hi lo + hi hi in float32.  The
kernels run only on a GPU; here:

(a) a plain reader of the packed buffer, following the kernel's fragment
    index formulas (g = lane // 4, t = lane % 4, per k-step and n-tile),
    recovers W0 in the tile's feature order zero-padded to 40, W1 with its
    within-8 input permutation undone, the biases, W2 and the freqs; hi is
    TF32 (its 13 low mantissa bits zero) and hi + lo gives each weight
    back within 2^-22 of it;
(b) an emulation of the warp's tile evaluation (TF32 rounding to nearest,
    ties away, by integer operations on the float32 bits; exact products
    and float32 sums) on 100,000 points in the map, off it, on the clip
    edges and NaN holds the port's float32 ``NeuralCostmap.lookup_ch0`` and
    the JAX ``NeuralCostmap.lookup_ch0`` on the same numpy weights within
    ``TILE_ATOL``, and one TF32 pass instead of three misses it by at least
    10x: the reason for the split.

The emulation is for these tests only; the port's plain versions evaluate
the field in float32 through ``lookup_ch0``.  Its helpers take the field's
spec (F and the hidden widths; ``tests/test_torch_field_tile_specs.py``
runs them at other specs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.costs.neural_costmap import NeuralCostmap as JaxField
from autorally_tpu_torch.costs import NeuralCostmap
from autorally_tpu_torch.ops import rollout_kernel as rk

F = 8
LAYERS = (2 + 4 * F, 64, 64, 1)
K1 = 40                                   # features padded to 5 k-steps
FSPEC = (F, 64, 64)
XB, YB = (20.0, 30.0), (-5.0, 5.0)
# 3xTF32 against float32 on field values of order 1 (largest |value| over
# these points 4.6): calibrated on the CPU, max 3-pass error 1.5e-6
# against the port and 1.4e-6 against JAX (which differ by 9.5e-7 from
# each other), one pass 2.3e-3 against both.
TILE_ATOL = 1e-5


def _arrays(seed=11, fspec=FSPEC):
    """He-normal weights and small biases of the field spec ``fspec`` (F
    and the hidden widths) from a numpy seed, over a 10 m x 10 m map."""
    rs = np.random.default_rng(seed)
    layers = rk.field_layers(fspec)
    W = [(np.sqrt(2.0 / a) * rs.standard_normal((a, b))).astype(np.float32)
         for a, b in zip(layers[:-1], layers[1:])]
    B = [(0.1 * rs.standard_normal(b)).astype(np.float32) for b in layers[1:]]
    freqs = ((2.0 ** np.arange(fspec[0])) * np.pi).astype(np.float32)
    r_c1 = np.array([1 / (XB[1] - XB[0]), 0, 0], np.float32)
    r_c2 = np.array([0, 1 / (YB[1] - YB[0]), 0], np.float32)
    trs = np.array([-XB[0] / (XB[1] - XB[0]), -YB[0] / (YB[1] - YB[0]), 1],
                   np.float32)
    return dict(weights=tuple(W), biases=tuple(B), freqs=freqs, r_c1=r_c1,
                r_c2=r_c2, trs=trs)


@pytest.fixture(scope="module")
def fields():
    """(port field on the CPU, JAX field, packed buffer), same arrays.

    torch's float32 sin on the CPU was seen to be off by up to 1.5e-4 at
    arguments of a few hundred in one thread's share of the first large
    (multi-threaded) call of a process, and exact afterwards; one such call
    here keeps that out of the comparisons."""
    torch.sin(torch.linspace(0.0, 128 * np.pi, 1 << 18))
    a = _arrays()
    field = NeuralCostmap.build(a["weights"], a["biases"], a["freqs"],
                                a["r_c1"], a["r_c2"], a["trs"], device="cpu")
    jfield = JaxField(tuple(jnp.asarray(w) for w in a["weights"]),
                      tuple(jnp.asarray(b) for b in a["biases"]),
                      *(jnp.asarray(a[k]) for k in ("freqs", "r_c1", "r_c2",
                                                    "trs")))
    return field, jfield, rk._pack_field(field)


def _tile_order(fspec=FSPEC):
    """The tile's feature columns: [u, v, 0, 0, then per frequency sin uF,
    sin vF, cos uF, cos vF, then zeros up to K1 (the columns rounded up to
    a multiple of 8)] as indices of the features [u, v, sin uF, sin vF,
    cos uF, cos vF] (-1: a zero column)."""
    f = fspec[0]
    order = [0, 1, -1, -1]
    for n in range(f):
        order += [2 + n, 2 + f + n, 2 + 2 * f + n, 2 + 3 * f + n]
    return order + [-1] * (-len(order) % 8)


def _read_packed(packed: torch.Tensor, fspec=FSPEC) -> dict:
    """Read the packed buffer as the kernel does, for the field spec
    ``fspec``: lane (g, t)'s float4 of k-step ks and n-tile nt is {b0 hi,
    b1 hi, b0 lo, b1 lo}; the first layer's b0 and b1 are rows 8 ks + t
    and 8 ks + t + 4 of W0 (tile order), column 8 nt + g; each next
    layer's rows 8 ks + 2t and 8 ks + 2t + 1 of its W.  Every hidden width
    is read padded to a multiple of 8 (n-tiles), as the fragments hold it.
    Returns "W0", "W1", ... as (hi, lo), "b0", "b1", ... (padded), "Wout"
    (padded; the tile's order without a hidden layer), "bout", "freqs" and
    the zero "pad"."""
    p = packed.numpy()
    hidden = list(fspec[1:])
    widths = [-(-h // 8) * 8 for h in hidden]
    kins = [len(_tile_order(fspec))] + widths[:-1]
    out, at = {}, 0
    for i, (kin, w) in enumerate(zip(kins, widths)):
        n = kin * w * 2          # (kin / 8) (w / 8) fragments of 32 x 4
        frags = p[at:at + n].reshape(kin // 8, w // 8, 32, 4)
        at += n
        hi = np.full((kin, w), np.nan, np.float32)
        lo = np.full((kin, w), np.nan, np.float32)
        for ks in range(kin // 8):
            for nt in range(w // 8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    r0 = 8 * ks + (2 * t if i > 0 else t)
                    r1 = r0 + (1 if i > 0 else 4)
                    c = 8 * nt + g
                    f = frags[ks, nt, lane]
                    hi[r0, c], hi[r1, c], lo[r0, c], lo[r1, c] = f
        out[f"W{i}"] = (hi, lo)
    for i, w in enumerate(widths):
        out[f"b{i}"] = p[at:at + w]
        at += w
    n_out = widths[-1] if widths else len(_tile_order(fspec))
    out.update(Wout=p[at:at + n_out], bout=p[at + n_out:at + n_out + 1],
               freqs=p[at + n_out + 1:at + n_out + 1 + fspec[0]],
               pad=p[at + n_out + 1 + fspec[0]:])
    return out


def _tf32(x: np.ndarray) -> np.ndarray:
    """To TF32, nearest, ties away from zero, on the float32 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_bits_clear(x: np.ndarray) -> bool:
    return bool((np.asarray(x, np.float32).view(np.uint32) & 0x1FFF == 0)
                .all())


@pytest.mark.parametrize("layer", ["W0", "W1"])
def test_packed_fragments_give_back_the_weights(fields, layer):
    field, _, packed = fields
    assert packed.numel() == rk.FIELD_PACK_FLOATS == 13516
    assert tuple(_tile_order()) == rk.FIELD_TILE_FEATURES
    hi, lo = _read_packed(packed)[layer]
    assert not np.isnan(hi).any() and not np.isnan(lo).any()  # all written
    W = field.weights[0 if layer == "W0" else 1].numpy()
    if layer == "W0":
        order = np.array(_tile_order())
        assert (hi[order < 0] == 0).all() and (lo[order < 0] == 0).all()
        hi, lo = hi[order >= 0], lo[order >= 0]
        W = W[order[order >= 0]]
    # the split: hi and lo are TF32, rounded to nearest as cvt.rna does
    assert _tf32_bits_clear(hi) and _tf32_bits_clear(lo)
    np.testing.assert_array_equal(hi, _tf32(W))
    np.testing.assert_array_equal(lo, _tf32(W - hi))
    err = np.abs(hi.astype(np.float64) + lo - W)
    assert (err <= 2.0 ** -22 * np.abs(W)).all(), err.max()


def test_packed_tail_is_float32_biases_output_layer_and_freqs(fields):
    field, _, packed = fields
    r = _read_packed(packed)
    (_, _, W2), (b0, b1, b2) = field.weights, field.biases
    for got, want in ((r["b0"], b0), (r["b1"], b1),
                      (r["Wout"], W2.reshape(-1)), (r["bout"], b2),
                      (r["freqs"], field.freqs)):
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(r["pad"], 0.0)
    assert (r["pad"].size + 201) % 4 == 0


def _points(n=100_000, seed=12):
    """World points: 60 % in the map, 30 % up to 5 m off it, 10 % on and
    just beside the clip edges; then NaN and infinite coordinates."""
    rs = np.random.default_rng(seed)
    n_in, n_off = 6 * n // 10, 3 * n // 10
    n_edge = n - n_in - n_off
    x = np.concatenate([rs.uniform(*XB, n_in), rs.uniform(XB[0] - 5,
                                                          XB[1] + 5, n_off),
                        rs.choice([XB[0], XB[1], XB[0] + 1e-4, XB[1] - 1e-4,
                                   XB[0] - 1e-4], n_edge)])
    y = np.concatenate([rs.uniform(*YB, n_in), rs.uniform(YB[0] - 5,
                                                          YB[1] + 5, n_off),
                        rs.uniform(YB[0] - 1, YB[1] + 1, n_edge)])
    y[-n_edge // 2:] = rs.choice([YB[0], YB[1]], n_edge - n_edge // 2)
    x, y = x.astype(np.float32), y.astype(np.float32)
    x[:50], y[50:100], x[100:150], y[100:150] = np.nan, np.nan, np.nan, np.nan
    x[150:160], y[160:170] = np.inf, -np.inf
    return x, y


def _tile_eval(field: NeuralCostmap, packed: torch.Tensor, x, y,
               passes: int, fspec=FSPEC) -> np.ndarray:
    """The warp's tile evaluation: the lanes' features in the tile's order,
    each hidden layer from the bias plus lo_a hi_b + hi_a lo_b + hi_a hi_b
    (``passes`` 3) or hi_a hi_b alone (1), TF32 products exact in float32,
    sums in float32, ReLU; the output layer in float32 (without a hidden
    layer, the output alone, in float32)."""
    r = _read_packed(packed, fspec)
    u, v = field.world_to_norm(torch.tensor(x), torch.tensor(y))
    u = torch.where(torch.isnan(u), 0.0, torch.clamp(u, 0.0, 1.0))
    v = torch.where(torch.isnan(v), 0.0, torch.clamp(v, 0.0, 1.0))
    feats = field._features(u, v).numpy()
    order = np.array(_tile_order(fspec))
    tile = np.where(order >= 0, feats[:, np.maximum(order, 0)],
                    np.float32(0)).astype(np.float32)

    def layer(a, hl, bias):
        (bh, bl), ah = hl, _tf32(a)
        mm = lambda p, q: torch.from_numpy(p) @ torch.from_numpy(q)
        acc = torch.from_numpy(bias) + mm(ah, bh)
        if passes == 3:
            al = _tf32(a - ah)
            acc = torch.from_numpy(bias) + (mm(al, bh) + mm(ah, bl)) + mm(
                ah, bh)
        return torch.relu(acc).numpy()

    h = tile
    for i in range(len(fspec) - 1):
        h = layer(h, r[f"W{i}"], r[f"b{i}"])
    return (torch.from_numpy(h) @ torch.from_numpy(r["Wout"][:, None])
            ).numpy()[:, 0] + r["bout"][0]


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("reference", ["port", "jax"])
def test_tile_evaluation_against_the_float32_field(fields, reference,
                                                   passes):
    field, jfield, packed = fields
    x, y = _points()
    got = _tile_eval(field, packed, x, y, passes)
    if reference == "port":
        want = field.lookup_ch0(torch.tensor(x), torch.tensor(y)).numpy()
    else:
        want = np.asarray(jfield.lookup_ch0(jnp.asarray(x), jnp.asarray(y)))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(want).max() > 1.0               # values of order 1
    err = np.abs(got - want).max()
    if passes == 3:
        assert err <= TILE_ATOL, err
    else:
        assert err >= 10 * TILE_ATOL, err

