"""What reading a torch.profiler trace costs on the card's host, and whether
the raw Kineto events hold the same device events as ``prof.events()``.

    python3 tools/profiler_events.py    # on a machine with one H100, ~100 s

Builds the kernels, draws full-width ``zamba2-1.2b`` (as ``chip_smoke.py``'s
``hybrid_weights``), decodes 16 rows at prompts 256 on the dense cache,
traces 8 decode ticks with CPU and CUDA activity, then reads the device
events twice: from ``prof.profiler.kineto_results.events()`` (what
``chip_smoke.trace`` reads) and from ``prof.events()`` (which builds the
whole event tree in Python).  Prints one JSON line: the seconds of each
read, the event counts, the device busy time each sums, and whether the
two hold the same events by name.
"""
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as c
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    c.phase_env()
    c.phase_build()
    cfg, p = c.hybrid_weights()
    params = c.cast_params(p, torch.bfloat16, "cuda")
    del p
    model = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **c.SSM_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    while eng.decode_dispatches < 4:
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    t1 = time.perf_counter()
    tree = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    t2 = time.perf_counter()
    a, b = Counter(n for n, _ in raw), Counter(n for n, _ in tree)
    print(json.dumps({"device": c.smi_line(), "raw_s": t1 - t0, "events_s": t2 - t1,
                      "n_raw": len(raw), "n_events": len(tree),
                      "busy_raw_ms": sum(d for _, d in raw) / 1e3,
                      "busy_events_ms": sum(d for _, d in tree) / 1e3,
                      "names_equal": a == b}), flush=True)


if __name__ == "__main__":
    main()
