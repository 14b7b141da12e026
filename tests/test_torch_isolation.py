"""The port stands apart from the reference package and from the CPU:
no port module imports ``jax`` or ``repro`` (the prefix store included);
every reference config builds, none refused; the dense cache runs; a
default-device entry point on a host
without CUDA raises instead of running on the CPU; and ``chip_smoke.py``
prints no result without a card."""

import ast
import subprocess
import sys
from pathlib import Path
import pytest
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import _REGISTRY
from repro_torch.core.storage import ObjectStore
from repro_torch.launch.train import run_train_span
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.train.data import DataConfig, SyntheticLM

torch.set_num_threads(1)  # the test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert ROOT / "src" / "repro_torch" / "serving" / "prefix_store.py" in PORT_FILES
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "ml_dtypes", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.fixture(scope="module")
def tiny():
    m = Model(reduced(get_arch("ds-paper-100m")))
    return m, m.init(0, device="cpu")


def test_dense_cache_mode_runs(tiny):
    """``cache_mode="dense"``, the reference's default and now the port's,
    serves: no pages, the whole per-slot reservation as the cache peak."""
    m, p = tiny
    eng = ServeEngine(m, p, device="cpu", cache_mode="dense", max_batch=2, max_len=32)
    assert ServeEngine(m, p, device="cpu").cache_mode == "dense"
    eng.submit([Request(uid="a", prompt=[1, 2, 3], max_new_tokens=3)])
    assert len(eng.run_to_completion()[0].output) == 3
    assert eng.peak_pages == 0 and "total_pages" not in eng.snapshot()
    assert eng.peak_cache_bytes == 2 * eng.cache["k"].numel() * eng.cache["k"].element_size()


@pytest.mark.parametrize("knob", [dict(cache_mode="sparse"), dict(dispatch_mode="x"),
                                  dict(prefix_match="chunk"), dict(refill_policy="lazy")])
def test_invalid_engine_knobs_raise_value_error(tiny, knob):
    m, p = tiny
    with pytest.raises(ValueError):
        ServeEngine(m, p, device="cpu", **knob)


@pytest.mark.parametrize("arch", sorted(_REGISTRY))
def test_every_reference_config_builds(arch):
    """Every one of the reference's eleven configs builds in the port, none
    refused: ``Model`` at full width (nothing allocated), ``reduced`` and
    its weights, a ``SyntheticLM`` batch with the stub inputs the family
    takes (an encoder-decoder's frames, a VLM's patches), and a finite
    loss on it."""
    assert len(_REGISTRY) == 11
    cfg = get_arch(arch)
    assert Model(cfg).cfg is cfg
    small = reduced(cfg)
    m = Model(small)
    batch = SyntheticLM(small, DataConfig(seq_len=16, global_batch=2), device="cpu").batch(0)
    stubs = {"frames"} if small.is_encoder_decoder else set()
    stubs |= {"patches"} if small.n_vision_tokens else set()
    assert set(batch) == {"tokens", "labels"} | stubs
    with torch.no_grad():
        loss, _ = m.loss(m.init(0, device="cpu"), batch)
    assert torch.isfinite(loss)


def test_engine_refuses_params_on_another_device(tiny):
    m, p = tiny
    moved = {**p, "embed": p["embed"].to("meta")}
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(m, moved, device="cpu")


def test_default_device_raises_without_cuda(tiny, monkeypatch, tmp_path):
    """The default device is cuda: with no CUDA device every entry point
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, p = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_cache(2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(m, p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"layers": {"ln1": {"w": [[1.0]]}}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(m.cfg, DataConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_train_span({"arch": "ds-paper-100m", "start_step": 0, "num_steps": 1},
                       ObjectStore(str(tmp_path)), lambda progress=None: None)
    # the explicit CPU request still works
    eng = ServeEngine(m, p, device="cpu", max_len=32, total_pages=4, page_size=8,
                      cache_mode="paged")
    eng.submit([Request(uid="a", prompt=[1, 2, 3], max_new_tokens=2)])
    assert len(eng.run_to_completion()[0].output) == 2


def test_chip_smoke_prints_no_result_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result,
    in the checkout and as a lone file outside it."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
