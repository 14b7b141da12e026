"""The port's GPipe schedule (``train/pipeline.py``) on 4 CPU ranks (gloo,
a ("pipe",) mesh) with the reference test's sizes (S 4, M 8, MB 2, D
16, ``tests/test_pipeline.py``): its output at 1e-5 of the reference's
``pipeline_apply`` on 4 forced host devices (run in a subprocess, which
also draws the weights and microbatches with ``jax.random``) and of the
sequential loop, with the stages' stack whole on every rank and laid out
one stage a rank as DTensors; and ``bubble_fraction``.

The ranks (``torch_mesh_ranks.pipeline_rank``) import torch and the port
alone."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.train.pipeline import bubble_fraction
from torch_mesh_ranks import pipeline_rank, spawn

torch.set_num_threads(1)  # the test workers share the host's cores

SRC = str(Path(__file__).resolve().parents[1] / "src")

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.train.pipeline import pipeline_apply

mesh = jax.make_mesh((4,), ("pipe",), axis_types=(AxisType.Auto,))
S, M, MB, D = 4, 8, 2, 16
key = jax.random.PRNGKey(0)
w = jax.random.normal(key, (S, D, D)) * 0.3
b = jax.random.normal(jax.random.fold_in(key, 1), (S, D)) * 0.1
x = jax.random.normal(jax.random.fold_in(key, 2), (M, MB, D))

def stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])

seq = x
for s in range(S):
    seq = jnp.tanh(seq @ w[s] + b[s])
with jax.set_mesh(mesh):
    out = jax.jit(lambda pp, xx: pipeline_apply(mesh, pp, xx, stage_fn))({"w": w, "b": b}, x)
np.savez(sys.argv[1], w=np.asarray(w), b=np.asarray(b), x=np.asarray(x), out=np.asarray(out),
         seq=np.asarray(seq))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(root / "ref.npz")],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = dict(np.load(root / "ref.npz"))
    torch.save({k: torch.from_numpy(ref[k]) for k in ("w", "b", "x")}, root / "inputs.pt")
    spawn(pipeline_rank, 4, root)
    return ref, torch.load(root / "out.pt")


@pytest.mark.parametrize("layout", ["whole", "dtensor"])
def test_pipeline_matches_reference_and_sequential(run, layout):
    ref, out = run
    got = out[layout].numpy()
    np.testing.assert_allclose(got, ref["out"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref["seq"], rtol=1e-5, atol=1e-5)


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    assert bubble_fraction(1, 8) == 0.0
