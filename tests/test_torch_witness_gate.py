"""``chip_smoke.py``'s bf16 logits gate (``witness_gate``, which
``ssm_eval`` and ``hybrid_eval`` hold) on CPU tensors from a toy forward:
logits ``h @ W`` of std ~4 through a stand-in kernel (``head``) that the
controls wrap, bf16 against an f32 witness.  A route equal to the plain
path holds; a fault above the row ratio fails; a control that the f32 1e-1
comparison fails but that stays within the ratio marks the gate blind,
and one that the comparison passes is reported and not required.  Then
the SSD controls on the port's ``ops.ssd`` (plain path on the CPU): each
moves half the heads and leaves the other half as they were."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

torch.set_num_threads(1)  # the test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # defines the phases; runs nothing

BATCH, SEQ, WIDTH, VOCAB, PADDED = 2, 64, 16, 120, 128
PLAIN = {"use_kernel": False}


def toy(kernel=lambda z: z):
    """``(logits, witness_logits, kern)``: the bf16 and f32 forwards of one
    toy model, the kernel route through ``kern.head`` (what the controls
    patch), the plain route past it."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((BATCH, SEQ, WIDTH)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((WIDTH, PADDED)).astype(np.float32))
    kern = types.SimpleNamespace(head=kernel)

    def forward(dtype):
        def run(use_kernel=True):
            z = h.to(dtype) @ w.to(dtype)
            return (kern.head(z) if use_kernel else z).float()
        return run

    return forward(torch.bfloat16), forward(torch.float32), kern


def add_at_one_logit(value: float):
    def wrap(real):
        def head(z):
            z = real(z).clone()
            z[0, 0, 0] += value
            return z
        return head
    return wrap


def gate(controls=None, kernel=lambda z: z):
    logits, witness, kern = toy(kernel)
    ctrl = {name: (kern, "head", wrap) for name, wrap in (controls or {}).items()}
    return smoke.witness_gate(logits, PLAIN, types.SimpleNamespace(vocab_size=VOCAB), witness,
                              ctrl, alone={"kernel": {"use_kernel": True}},
                              plain_variants={"plain_again": PLAIN})


def test_route_equal_to_the_plain_path_holds():
    g = gate({"output x1.5": smoke._scaled(1.5, lambda o: o)})
    assert g["held"] and "miss" not in g
    assert g["row_ratios"] == [1.0, 1.0]
    assert g["issue_gate"]["against_plain_max_abs"] == 0.0
    assert g["issue_gate"]["plain_again_worst_over_gate"] == 0.0
    assert g["by_kernel_alone"] == {"kernel": 0.0}
    assert all(d > 0 for d in g["row_distance_plain"])  # bf16 sits off the f32 witness
    caught = g["controls"]["output x1.5"]
    assert caught["required"] and caught["f32_worst_over_issue_gate"] > 1
    assert min(caught["row_ratios"]) > smoke.WITNESS_ROW_RATIO


def test_fault_above_the_ratio_fails():
    g = gate(kernel=lambda z: z * 1.05)
    assert not g["held"]
    assert max(g["row_ratios"]) > smoke.WITNESS_ROW_RATIO
    assert g["miss"].startswith("a row's distance ratio")


def test_required_control_within_the_ratio_marks_the_gate_blind():
    g = gate({"one logit +1": add_at_one_logit(1.0)})
    blind = g["controls"]["one logit +1"]
    assert blind["required"] and blind["f32_worst_over_issue_gate"] > 1
    assert max(blind["row_ratios"]) <= smoke.WITNESS_ROW_RATIO
    assert max(g["row_ratios"]) <= smoke.WITNESS_ROW_RATIO
    assert not g["held"]
    assert "blind" in g["miss"] and "one logit +1" in g["miss"]


def test_control_the_f32_comparison_passes_is_reported_not_required():
    g = gate({"one logit +0.05": add_at_one_logit(0.05)})
    small = g["controls"]["one logit +0.05"]
    assert not small["required"] and small["f32_worst_over_issue_gate"] <= 1
    assert max(small["row_ratios"]) <= smoke.WITNESS_ROW_RATIO
    assert g["held"]


def _ssd_inputs(seed=0, b=2, l=64, h=4, p=8, n=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((b, l, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, l, n)).astype(np.float32))
    return x, dt, A, B, C


@pytest.mark.parametrize("control", ["SSD output x1.08 on half the heads",
                                     "chunk states x1.08 on half the heads"])
def test_ssd_controls_move_half_the_heads(control):
    args = _ssd_inputs()
    y0, final0 = ops.ssd(*args, chunk=16)
    module, attr, wrap = smoke.ssd_controls()[control]
    assert module is ops
    with smoke.patched(module, attr, wrap):
        y1, final1 = ops.ssd(*args, chunk=16)
    assert getattr(ops, attr).__name__ == attr  # the real op is back
    half = y0.shape[2] // 2
    torch.testing.assert_close(y1[:, :, half:], y0[:, :, half:], rtol=0, atol=0)
    if control.startswith("SSD output"):
        torch.testing.assert_close(y1[:, :, :half], y0[:, :, :half] * 1.08, rtol=0, atol=0)
        torch.testing.assert_close(final1, final0, rtol=0, atol=0)
    else:  # through the inter-chunk scan: the first chunk is untouched
        torch.testing.assert_close(y1[:, :16], y0[:, :16], rtol=0, atol=0)
        assert (y1[:, 16:, :half] - y0[:, 16:, :half]).abs().max() > 1e-3
        torch.testing.assert_close(final1[:, :half], final0[:, :half] * 1.08, rtol=1e-5, atol=0)
        torch.testing.assert_close(final1[:, half:], final0[:, half:], rtol=0, atol=0)
