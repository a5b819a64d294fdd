"""The state-emission kernel's 3xTF32 arithmetic (K3), emulated in plain
torch on the CPU, and the parameter-row layouts it reads.

The kernel multiplies on the tensor cores in TF32 (10-bit mantissa): each
operand a is split into a_hi = tf32(a) and a_lo = tf32(a - a_hi), and
q = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in float32. Here the
rounding is done by bit masking (``cuda_emission.tf32_round``) and the three
products by float32 matmuls, whose products of two TF32 values are exact.
The emulation is held to K3's bar, rtol 1e-5 / atol 1e-3, against a float64
reference on SAT-scale magnitudes (``chip_smoke``'s GMM draw, features of
scale 1 to 8); one TF32 product alone misses that bar, which is why the
kernel pays for three. The tensor core's own accumulation order is not
modelled: the card tests and ``chip_smoke.py`` hold the kernel itself.
"""

import numpy as np
import pytest
import torch

import montreal_forced_aligner_tpu.ops.pallas_emission as PE
from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

from torch_port_inputs import gmm_arrays

RTOL, ATOL = 1e-5, 1e-3


def _logsumexp_g(q):  # (G, ...) -> (...)
    return torch.logsumexp(q, dim=0)


def _sat_case(scale, seed=0, T=48, S=40, P=12, G=32, D=40):
    """[x, x^2, 1, 0] rows (T, D2p) and the states' parameter rows
    (S, G, D2p), float32, from the SAT-scale draw."""
    miv, iv, gc = gmm_arrays(seed, P, G, D, padded_pdfs=(1,))
    rows = gmm_params_from_numpy(miv, iv, gc).rows
    rng = np.random.RandomState(seed + 100)
    feats = torch.from_numpy((rng.randn(1, T, D) * scale).astype(np.float32))
    pdf = torch.from_numpy(rng.randint(0, P, S).astype(np.int64))
    xx = CE.quad_features(feats, rows.shape[2])[0]
    return xx, rows[pdf]


def _reference(xx, w):
    """float64 emissions (T, S) from the float32 operands."""
    q = torch.einsum("td,sgd->gts", xx.double(), w.double())
    return _logsumexp_g(q)


def _tf32_products(xx, w, passes):
    """float32 emissions (T, S) from TF32 products: 3 passes (the kernel's
    3xTF32) or 1 (plain TF32)."""
    x_hi, x_lo = CE.tf32_split(xx)
    w_hi, w_lo = CE.tf32_split(w)

    def mm(a, b):
        return torch.einsum("td,sgd->gts", a, b)

    if passes == 3:
        q = mm(x_lo, w_hi) + mm(x_hi, w_lo) + mm(x_hi, w_hi)
    else:
        q = mm(x_hi, w_hi)
    return _logsumexp_g(q).double()


def _share_of_bar(got, want):
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


@pytest.mark.parametrize("scale", [1.0, 3.0, 8.0])
def test_3xtf32_products_meet_the_kernel_bar(scale):
    xx, w = _sat_case(scale)
    want = _reference(xx, w)
    got = _tf32_products(xx, w, passes=3)
    assert torch.isfinite(got).all()
    assert _share_of_bar(got, want) <= 1.0


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_one_tf32_product_misses_the_bar(scale):
    xx, w = _sat_case(scale)
    want = _reference(xx, w)
    assert _share_of_bar(_tf32_products(xx, w, passes=1), want) > 10.0
    # and float32 products, the plain version's, meet it
    plain = _logsumexp_g(torch.einsum("td,sgd->gts", xx, w)).double()
    assert _share_of_bar(plain, want) <= 1.0


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor(
        [1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23, 1.0 + ulp * 1.5,
         -(1.0 + ulp / 2), -1.0e30, 123.456, 0.0],
        dtype=torch.float32,
    )
    got = CE.tf32_round(x)
    assert not (got.view(torch.int32) & 0x1FFF).any()  # low 13 bits clear
    np.testing.assert_array_equal(
        got[:5].double().numpy(),
        [1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, -(1.0 + ulp)],
    )
    hi, lo = CE.tf32_split(x)
    assert torch.equal(hi, got)
    assert ((hi.double() - x.double()).abs() <= x.double().abs() * 2.0 ** -11).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("D", [39, 40, 13])
def test_pack_rows_matches_the_jax_rows_on_the_used_columns(D):
    P, G = 7, 5
    miv, iv, gc = gmm_arrays(D, P, G, D, padded_pdfs=(2,))
    port = CE.pack_rows(miv, iv, gc)
    ref = PE.pack_rows(miv, iv, gc)
    d2p = port.shape[2]
    assert d2p % 8 == 0 and 2 * D + 1 <= d2p < 2 * D + 10
    np.testing.assert_array_equal(port[:, :, : 2 * D + 1], ref[:, :, : 2 * D + 1])
    assert not port[:, :, 2 * D + 1 :].any() and not ref[:, :, 2 * D + 1 :].any()


@pytest.mark.parametrize("D", [39, 40])
def test_split_rows_layout(D):
    """``split_rows`` holds, for k-step k0 and lane column c, the 4 values
    [hi(k0+c), hi(k0+c+4), lo(k0+c), lo(k0+c+4)]; hi + lo is the row."""
    P, G = 6, 3
    miv, iv, gc = gmm_arrays(D + 1, P, G, D, padded_pdfs=(4,))
    params = gmm_params_from_numpy(miv, iv, gc)
    rows, split = params.rows, params.rows_split
    d2p = rows.shape[2]
    assert split.shape == (P, G, 2 * d2p) and split.is_contiguous()
    v = split.reshape(P, G, d2p // 8, 4, 4)
    hi = torch.empty_like(rows)
    lo = torch.empty_like(rows)
    for k in range(d2p // 8):
        for c in range(4):
            hi[:, :, 8 * k + c] = v[:, :, k, c, 0]
            hi[:, :, 8 * k + c + 4] = v[:, :, k, c, 1]
            lo[:, :, 8 * k + c] = v[:, :, k, c, 2]
            lo[:, :, 8 * k + c + 4] = v[:, :, k, c, 3]
    assert torch.equal(hi, CE.tf32_round(rows))
    assert torch.equal(lo, CE.tf32_round(rows - hi))
    err = (hi.double() + lo.double() - rows.double()).abs()
    assert (err <= rows.double().abs() * 2.0 ** -21).all()


def test_split_rows_refuses_rows_not_a_multiple_of_8():
    with pytest.raises(ValueError):
        CE.split_rows(torch.zeros((2, 3, 84)))
