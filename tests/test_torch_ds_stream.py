"""The port's queue-streaming ``distributed-serve`` lease against the
reference's, prefix store off, on reduced ``ds-paper-100m`` (plain path
on the CPU, ``"device": "cpu"`` in the job), both from the reference's
seed-0 weights written as a checkpoint by the reference.

Each case runs the same request queue, job file, fleet and (where named)
chaos drill through both packages' ``DSRuntime`` and ``SimRunner`` and
holds equal: every object the lease wrote under its output prefix
(per-request records with their completions, the lease summaries
``RESULTS*.json`` with every counter, the segment records under
``leases/`` and the generation checkpoints), the request queue's counts
after the run (every request acked, none dead) and the runs' summaries.
Cases: a drain to ``expected_requests``; the idle exit; a uid collision
(the renamed uid's message-id suffix normalised: message ids are
random); a lease that resumes and merges an earlier holder's records;
elastic slices (``stream_slice_ticks`` 2) over two workers; the seeded
revocation drill with generation checkpoints (``checkpoint_resumes`` and
``tokens_recovered`` above zero); ``stop_token`` and temperature rows.

The engine's recovery seam on its own, against the reference's:
``checkpoint_slot`` mid-decode and ``submit_resume`` on a fresh engine
(paged and dense; outputs, records and every counter), and the
``_try_resume`` ladder (a valid checkpoint resumes; a missing, tampered
or mismatched one is a counted fallback)."""

import dataclasses
import re
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.chaos as jchaos
import repro.launch.serve as jserve
import repro_torch.core as tcore
import repro_torch.core.chaos as tchaos
import repro_torch.launch.serve as tserve
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)  # the test workers share the host's cores

TICK = 30.0
SHARED = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "device": "cpu", "run": "w",
          "max_new_tokens": 4, "max_len": 32, "max_batch": 2, "prefill_chunk": 4}
PROMPTS = [[1, 2, 3], [4, 5], [7, 8, 9, 10], [11], [12, 13]]
SYS_PROMPT = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
# the reference's drill workload (tests/test_elastic_serving.py), prefix store off
DRILL = {**SHARED, "max_new_tokens": 12, "cache_mode": "paged", "page_size": 8,
         "prefix_cache": True}
DRILL_CFG = dict(cpu_shares=8192, memory_mb=16384, idle_alarm_seconds=100_000.0,
                 autoscale="queue", min_workers=1, max_workers=2,
                 autoscale_queue_per_worker=2, autoscale_up_cooldown_seconds=TICK,
                 autoscale_down_cooldown_seconds=3600.0)


def _bodies(prompts, **extra):
    return [{"uid": f"q{i}", "prompt": p, **extra} for i, p in enumerate(prompts)]


CASES = {
    "drain_expected": dict(bodies=_bodies(PROMPTS), groups=[{"expected_requests": 5}]),
    "idle_exit": dict(bodies=[{"uid": "only", "prompt": [1, 2, 3]}],
                      groups=[{"stream_idle_polls": 2}]),
    "uid_collision": dict(bodies=[{"uid": "dup", "prompt": [1, 2, 3]},
                                  {"uid": "dup", "prompt": [9, 9]}],
                          groups=[{"expected_requests": 2}]),
    "lease_resume": dict(bodies=[{"uid": "q1", "prompt": [1, 2, 3]}],
                         groups=[{"expected_requests": 2}],
                         earlier={"q0": {"prompt": [9, 9], "completion": [1, 2, 3, 4]}}),
    "elastic_slices": dict(bodies=_bodies(PROMPTS, max_new_tokens=6),
                           groups=[{"expected_requests": 5, "stream_slice_ticks": 2,
                                    "stream_idle_polls": 8}] * 2,
                           cfg={"cluster_machines": 2}),
    "revocation_drill": dict(bodies=_bodies([SYS_PROMPT + [31 + i] for i in range(6)],
                                            max_new_tokens=12),
                             groups=[{"expected_requests": 6, "stream_slice_ticks": 2,
                                      "stream_idle_polls": 8, "request_visibility": 240.0,
                                      "request_max_receive_count": 6}] * 2,
                             job=DRILL, cfg=dict(DRILL_CFG, cluster_machines=1),
                             fleet={"startup_seconds": TICK, "market_seed": 7},
                             max_receive=6, drill=True),
    "stop_and_temperature": dict(
        bodies=[{"uid": f"q{i}", "prompt": p,
                 **({"temperature": 0.7} if i % 2 else {"stop_token": 7})}
                for i, p in enumerate(PROMPTS)],
        groups=[{"expected_requests": 5}], job={**SHARED, "cache_mode": "paged",
                                                "page_size": 8}),
}


@pytest.fixture(scope="module")
def seed_weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "w", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def _normalise(obj):
    """Renamed collision uids carry the message id's first 8 characters
    (random per run): replace them by a fixed marker."""
    return re.sub(r"~[0-9a-f]{8}", "~<msg>", obj) if isinstance(obj, str) else obj


def _tree(store, prefix):
    out = {}
    for info in store.list(prefix):
        value = store.get_json(info.key)
        if isinstance(value, dict) and "requests" in value:
            value = {**value, "requests": {_normalise(k): v
                                           for k, v in value["requests"].items()}}
        out[_normalise(info.key)] = value
    return out


def run_stream(core, chaos_mod, serve_mod, root, spec):
    serve_mod.reset_serve_state()
    clk = core.VirtualClock()
    cfg = core.DSConfig(**{**dict(app_name="Stream", payload="distributed-serve",
                                  cluster_machines=1, tasks_per_machine=1,
                                  machine_type=["sim.large"], machine_price=1.0,
                                  sqs_message_visibility=240.0, check_if_done=False,
                                  monitor_poll_seconds=TICK), **spec.get("cfg", {})})
    rt = core.DSRuntime(cfg, store_root=str(root / "store"), clock=clk)
    rt.setup()
    out = "serve/stream"
    for uid, rec in spec.get("earlier", {}).items():
        rt.store.put_json(f"{out}/requests/{uid}.json", rec)
    rq_path = str(root / "requests.sqlite")
    rq = core.DurableQueue(rq_path, default_visibility=240.0,
                           max_receive_count=spec.get("max_receive", 3), clock=clk)
    rq.send_batch(spec["bodies"])
    rt.submit_job(core.JobFile(
        shared=dict(spec.get("job", SHARED), request_queue=rq_path, output_prefix=out),
        groups=[dict(g) for g in spec["groups"]]))
    rt.start_cluster(core.FleetFile(**spec.get("fleet", {"startup_seconds": 0.0})))
    chaos = None
    if spec.get("drill"):
        chaos = chaos_mod.ChaosMonkey.revocation_drill(
            rt.fleet, clk, seed=1234, n_revocations=1, start=3 * TICK, spacing=2 * TICK,
            notice_seconds=2 * TICK, store=rt.store, logs=rt.logs)
    summary = core.SimRunner(rt, tick_seconds=TICK, chaos=chaos).run(max_ticks=300)
    counts = rq.counts()
    rq.close()
    return {"objects": _tree(rt.store, f"{out}/"), "counts": counts,
            "summary": dataclasses.asdict(summary),
            "chaos": [dataclasses.asdict(r) for r in chaos.log] if chaos else None}


def _counter(objects, name):
    """A counter summed over each worker's last record (its final summary
    supersedes its slice/drain records, as the reference's drill test
    aggregates)."""
    finals, slices = {}, {}
    for key, value in objects.items():
        base = key.rsplit("/", 1)[-1][:-len(".json")]
        if "/leases/" in key:
            slices[base] = value
        elif "/RESULTS" in key:
            finals[base.split("RESULTS-", 1)[-1]] = value
    return sum(int(v.get(name, 0)) for v in {**slices, **finals}.values())


@pytest.mark.parametrize("case", list(CASES))
def test_stream_lease_matches_reference(seed_weights, tmp_path, case):
    spec = CASES[case]
    runs = {}
    for name, core, chaos_mod, serve_mod in (("ref", jcore, jchaos, jserve),
                                             ("port", tcore, tchaos, tserve)):
        root = tmp_path / name
        shutil.copytree(seed_weights / "ckpt", root / "store" / "ckpt")
        runs[name] = run_stream(core, chaos_mod, serve_mod, root, spec)
    want, got = runs["ref"], runs["port"]
    assert got["counts"] == want["counts"] == {"visible": 0, "in_flight": 0, "dead": 0}
    assert got["summary"] == want["summary"]
    assert got["chaos"] == want["chaos"]
    assert sorted(got["objects"]) == sorted(want["objects"])
    for key in want["objects"]:
        assert got["objects"][key] == want["objects"][key], key
    served = {k for k in want["objects"] if "/requests/" in k}
    n_requests = len(spec["bodies"]) + len(spec.get("earlier", {}))
    assert len(served) == n_requests
    if case == "revocation_drill":
        objs = want["objects"]
        assert _counter(objs, "revocation_notices") >= 1
        assert _counter(objs, "checkpoint_resumes") > 0
        assert _counter(objs, "tokens_recovered") > 0
        assert any("/checkpoints/" in k for k in objs)
    if case == "elastic_slices":
        assert _counter(want["objects"], "lease_slices") > 0


# ------------------------------------------- the engine's recovery seam
@pytest.fixture(scope="module")
def engines():
    """Reference and port engine factories on the same seed-0 weights."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {"ref": (lambda **kw: JEngine(jm, jp, **kw), JRequest),
            "port": (lambda **kw: ServeEngine(m, p, device="cpu", **kw), Request)}


RECOVERY_KW = {"paged": dict(cache_mode="paged", page_size=8, total_pages=10),
               "dense": dict(cache_mode="dense")}


def _recovery_run(make, Request, kw, cut):
    """An uninterrupted run, and a run checkpointed after ``cut`` emitted
    tokens, preempted and resumed on a fresh engine."""
    base = dict(max_batch=2, max_len=32, prefill_chunk=4, rng_seed=7, **kw)

    def reqs():
        return [Request(uid="a/0", prompt=[5, 6, 7, 8, 9, 10, 11, 12, 13], max_new_tokens=8,
                        temperature=0.5),
                Request(uid="b", prompt=[3, 1, 4], max_new_tokens=6)]

    whole = make(**base)
    whole.submit(reqs())
    want = {r.uid: list(r.output) for r in whole.run_to_completion()}
    a = make(**base)
    a.submit(reqs())
    while a.scheduler.slots[0].req is None or len(a.scheduler.slots[0].req.output) < cut:
        a.step()
    ckpts = [a.checkpoint_slot(row) for row in range(2)]
    for row in range(2):
        if a.scheduler.slots[row].req is not None:
            a.scheduler.preempt(row)
    b = make(**base)
    for ck in ckpts:
        if ck is not None:
            b.submit_resume(ck)
    b.submit([r for r in reqs() if r.uid not in {ck["uid"] for ck in ckpts if ck}])
    got = {r.uid: list(r.output) for r in b.run_to_completion()}
    snap = b.snapshot()
    return want, got, ckpts, {k: v for k, v in snap.items() if k != "timing"}, snap["timing"]


@pytest.mark.parametrize("cut", [2, 5])
@pytest.mark.parametrize("mode", list(RECOVERY_KW))
def test_checkpoint_resume_matches_reference(engines, mode, cut):
    """``checkpoint_slot`` mid-decode, then ``submit_resume`` on a fresh
    engine: the records, the resumed outputs (equal to an uninterrupted
    run's) and every counter equal the reference's."""
    ref = _recovery_run(*engines["ref"], RECOVERY_KW[mode], cut)
    port = _recovery_run(*engines["port"], RECOVERY_KW[mode], cut)
    assert port == ref
    want, got, ckpts, counters, _ = port
    assert got == want
    assert counters["checkpoint_resumes"] >= 1
    assert counters["tokens_recovered"] == sum(len(c["output"]) - 1 for c in ckpts if c)


def test_resume_ladder_matches_reference(engines, tmp_path):
    """``_try_resume``: a sealed checkpoint resumes; a missing, tampered or
    mismatched one is a counted ``checkpoint_fallback`` in both packages."""
    results = {}
    for name, serve_mod in (("ref", jserve), ("port", tserve)):
        make, Request = engines[name]
        core = jcore if name == "ref" else tcore
        ctx = SimpleNamespace(store=core.ObjectStore(str(tmp_path / name)),
                              clock=core.VirtualClock())
        base = dict(max_batch=2, max_len=32, prefill_chunk=4, rng_seed=7, cache_mode="paged",
                    page_size=8, total_pages=10)

        def req():
            return Request(uid="lad/0", prompt=[5, 6, 7, 8, 9], max_new_tokens=5,
                           temperature=0.5)

        a = make(**base)
        a.submit([req()])
        while a.scheduler.slots[0].req is None or len(a.scheduler.slots[0].req.output) < 2:
            a.step()
        sealed = serve_mod._seal_checkpoint(a.checkpoint_slot(0))
        key = f"ck/{serve_mod._uid_safe('lad/0')}.json"
        outcomes = []
        for label, record in (("valid", sealed), ("missing", None),
                              ("tampered", dict(sealed, output=[sealed["output"][0] + 1]
                                                + sealed["output"][1:])),
                              ("mismatched", serve_mod._seal_checkpoint(
                                  {**{k: v for k, v in sealed.items() if k != "sha"},
                                   "max_new_tokens": 99}))):
            if record is None:
                ctx.store.delete(key)
            else:
                ctx.store.put_json(key, record)
            eng = make(**base)
            r = req()
            resumed = serve_mod._try_resume(eng, ctx, "ck/", r)
            if resumed is None:
                eng.submit([r])
            out = eng.run_to_completion()[0].output
            outcomes.append((label, resumed is not None, list(out),
                             eng.stats.checkpoint_resumes, eng.stats.checkpoint_fallbacks,
                             eng.stats.tokens_recovered))
        results[name] = outcomes
    assert results["port"] == results["ref"]
    assert [o[1] for o in results["port"]] == [True, False, False, False]
    assert len({tuple(o[2]) for o in results["port"]}) == 1  # every rung lands on one output
