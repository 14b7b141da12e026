"""``chip_smoke.py``'s training phases of two checkouts side by side in one
call: each tree's ``train_parity``, ``family_train_parity`` and
``remat_train`` in a process of its own, in the order given, so that the
parent and the change meet the same host.

    python3 tools/train_ab.py build/parent . . build/parent   # one H100, ~15 min

Each run builds the tree's kernels (cached in its ``build/`` after the
first), draws the mamba2 and zamba2 weights as ``chip_smoke.main`` does,
then runs the three phases, each followed by its lap.  Every run's output
goes to ``chiprun_out/train_ab/<n>.log``; the script prints one JSON line
per run (the laps, and per case the card and CPU seconds, the peak and
whether the run passed) and exits non-zero when a run failed.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DRIVER = """
import sys, time
sys.path.insert(0, "src")
import chip_smoke as c
import repro_torch  # noqa: F401
c.phase_env()
c.phase_build()
cfg, params_cpu = c.ssm_weights()
hcfg, hparams_cpu = c.hybrid_weights()
c.lap("build, ssm_weights, hybrid_weights")
c.phase_train_parity()
c.lap("train_parity")
c.phase_family_train_parity((cfg, params_cpu), (hcfg, hparams_cpu))
c.lap("family_train_parity")
c.phase_remat_train(cfg, params_cpu)
c.lap("remat_train")
print(c.smi_line(), flush=True)
"""


def summarize(tree: str, out: str, rc: int) -> dict:
    rec = {"tree": tree, "rc": rc, "laps": {}, "cases": {}}
    plain = [line.strip() for line in out.splitlines() if line.strip()
             and not line.startswith("{")]
    rec["device"] = plain[-1] if rc == 0 and plain else None  # smi_line, printed last
    for line in out.splitlines():
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "lap" in obj:
            rec["laps"][obj["lap"]] = obj["seconds"]
        elif obj.get("phase") == "train_parity":
            for name, run in obj["runs"].items():
                rec["cases"][f"train_parity/{name}"] = {"card_s": run["card_s"],
                                                        "cpu_s": run["cpu_s"]}
        elif obj.get("phase") == "family_train_parity":
            for arch, case in obj["cases"].items():
                entry = {k: case.get(k) for k in ("card_s", "cpu_s", "max_memory_allocated_bytes")}
                if "donated_against_functional" in case:
                    moe = case["donated_against_functional"]
                    entry.update({k: moe[k] for k in ("functional_peak_bytes",
                                                      "donated_peak_bytes", "bit_for_bit")})
                rec["cases"][f"family_train_parity/{arch}"] = entry
        elif obj.get("phase") == "remat_train":
            rec["cases"]["remat_train"] = {
                "peak_bytes": obj["full_depth"]["max_memory_allocated_bytes"]}
    return rec


def main() -> int:
    trees = sys.argv[1:] or [".", "."]
    logs = ROOT / "chiprun_out" / "train_ab"
    logs.mkdir(parents=True, exist_ok=True)
    ok = True
    for i, tree in enumerate(trees):
        run = subprocess.run([sys.executable, "-c", DRIVER], cwd=ROOT / tree,
                             capture_output=True, text=True, timeout=1800)
        (logs / f"{i}.log").write_text(run.stdout + "\n--- stderr\n" + run.stderr)
        print(json.dumps(summarize(tree, run.stdout, run.returncode)), flush=True)
        ok = ok and run.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
