"""The port stands apart from the reference package and from the CPU:
no port module imports ``jax`` or ``repro`` (the prefix store included);
a model family not ported yet refuses with ``NotImplementedError`` (the
dense cache, ported since, runs); a default-device entry point on a host
without CUDA raises instead of running on the CPU; and ``chip_smoke.py``
prints no result without a card."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path
import pytest
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import ArchConfig, get_arch, reduced
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


def test_unported_model_features_refuse(tiny):
    m, _ = tiny
    dense = m.init_cache(2, 32, paged=False, device="cpu")  # the dense cache runs now
    assert set(dense) == {"k", "v"} and dense["k"].shape == (2, 2, 32, 2, 16)
    assert set(m.init_cache(2, 32, device="cpu")) == {"k", "v"}  # and is the default
    mla = ArchConfig(name="x-mla", family="moe", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab_size=256, n_experts=4, top_k=2,
                     use_mla=True, kv_lora_rank=32, rope_head_dim=8)
    assert Model(mla).cfg.use_mla  # MLA builds now
    vision = ArchConfig(name="x-vlm", family="vlm", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=4, d_ff=128, vocab_size=256, n_vision_tokens=8)
    assert Model(vision).cfg.n_vision_tokens == 8  # vision tokens build now
    assert reduced(vision).n_vision_tokens == 8
    # what is left unported: the encoder-decoder, learned positions and the
    # audio family, each refusal naming whisper
    encdec = dataclasses.replace(vision, name="x-encdec", family="dense", n_vision_tokens=0,
                                 is_encoder_decoder=True)
    with pytest.raises(NotImplementedError,
                       match="encoder-decoder not ported yet.*ROADMAP Queue 1: whisper"):
        Model(encdec)
    learned = dataclasses.replace(vision, name="x-pos", family="dense", n_vision_tokens=0,
                                  max_position_embeddings=512)
    with pytest.raises(NotImplementedError,
                       match="learned positions not ported yet.*ROADMAP Queue 1: whisper"):
        Model(learned)
    audio = ArchConfig(name="x-audio", family="audio", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab_size=256, is_encoder_decoder=True)
    with pytest.raises(NotImplementedError, match="family 'audio', encoder-decoder.*whisper"):
        Model(audio)
    with pytest.raises(NotImplementedError, match="dense, MoE, SSM, hybrid and VLM.*whisper"):
        reduced(audio)
    with pytest.raises(NotImplementedError, match="frame stub inputs.*whisper"):
        SyntheticLM(encdec, DataConfig(), device="cpu")


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
