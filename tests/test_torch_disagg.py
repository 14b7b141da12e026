"""Disaggregated prefill/decode serving and the cross-host prefix store in
the port, against the reference, on the CPU.

Layer by layer: the scheduler's role gates, the engine's and the
``distributed-serve`` job's knob validation (message for message with
the reference), and the engine-level handoff with a TTL sweep racing it
(fresh pins protect the chain; a destroyed chain falls back to the same
tokens).

End to end, the reference's three payload scenarios through both
packages' ``DSRuntime`` and ``SimRunner`` on reduced ``ds-paper-100m``
from the reference's seed-0 weights (written as a checkpoint by the
reference): two workers sharing a system prompt through the object
store (``tests/test_serve_stream.py``), a prefill lease and a decode
lease joined by a decode queue (same file), and the seeded revocation
drill with the store on (``tests/test_elastic_serving.py``).  Held
equal: every object under the output prefixes (completions, handoff
markers, lease summaries with every counter, segment records,
checkpoints), every queue's counts, the runs' summaries and chaos logs,
and the number of pages and pin markers in the store.  Page keys differ
by the port's framework tag, so the store is compared by count.  Byte
counters (``prefix_store_bytes_fetched``) are compared exactly: in f32
both packages write the same npz layout (leaf names, shapes, dtype and a
64-hex digest), so their blobs have equal sizes.  One counter is left
out: ``publish_dedup_hits`` counts resubmits that find a key's
background write still pending, a race with the publisher thread that
neither package fixes."""

import dataclasses
import os
import shutil
import time

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
from repro.serving.prefix_store import PrefixStore as JStore
from repro.serving.scheduler import RequestScheduler as JScheduler
from repro.serving.types import EngineStats as JStats
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_store import PrefixStore
from repro_torch.serving.scheduler import RequestScheduler
from repro_torch.serving.types import EngineStats

torch.set_num_threads(1)  # the test workers share the host's cores

TICK = 30.0
PAGE = 8


# ------------------------------------------------- scheduler role gates
def test_decode_scheduler_refuses_fresh_prefill_work():
    sched = RequestScheduler(2, EngineStats(), role="decode")
    with pytest.raises(RuntimeError, match="refuses fresh prefill work"):
        sched.submit([Request(uid="a", prompt=[1, 2])])
    assert sched.pending == []
    # sealed handoffs are the only admissible work, and they keep the
    # prefill worker's stream id
    req = Request(uid="h", prompt=[1, 2, 3])
    req.sample_stream = 5
    sched.submit_handoff(req)
    assert sched.pending[-1] is req and req.handoff
    assert sched._n_submitted == 6


def test_prefill_scheduler_refuses_handoff_admissions():
    sched = RequestScheduler(2, EngineStats(), role="prefill")
    with pytest.raises(RuntimeError, match="refuses handoff"):
        sched.submit_handoff(Request(uid="h", prompt=[1, 2]))
    sched.submit([Request(uid="a", prompt=[1, 2])])  # fresh work is fine
    assert len(sched.pending) == 1


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def test_scheduler_role_errors_match_reference():
    got, want = [], []
    for out, (sched_cls, stats, req) in ((want, (JScheduler, JStats, JRequest)),
                                         (got, (RequestScheduler, EngineStats, Request))):
        out.append(_error(lambda: sched_cls(2, stats(), role="verifier")))
        out.append(_error(lambda: sched_cls(2, stats(), role="decode").submit(
            [req(uid="a", prompt=[1]), req(uid="b", prompt=[2])])))
        out.append(_error(lambda: sched_cls(2, stats(), role="prefill").submit_handoff(
            req(uid="h", prompt=[1]))))
    assert got == want and all(e is not None for e in got)


# ------------------------------------------------- engine role validation
@pytest.fixture(scope="module")
def models():
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {"ref": (jm, jp, JEngine, JStore, JRequest, jcore),
            "port": (m, p, lambda *a, **k: ServeEngine(*a, device="cpu", **k), PrefixStore,
                     Request, tcore)}


INVALID_KNOBS = {
    "unknown_role": dict(worker_role="draft", cache_mode="paged", store=True),
    "prefill_without_store": dict(worker_role="prefill"),
    "decode_without_store": dict(worker_role="decode"),
    "store_on_dense_cache": dict(store=True),
    "store_without_prefix_cache": dict(store=True, cache_mode="paged", prefix_cache=False),
    "prefill_without_chunked_prefill": dict(worker_role="prefill", cache_mode="paged",
                                            store=True, prefill_chunk=0),
    "prefill_speculative": dict(worker_role="prefill", cache_mode="paged", store=True,
                                speculative="ngram"),
}


@pytest.mark.parametrize("case", list(INVALID_KNOBS))
def test_engine_knob_errors_match_reference(models, tmp_path, case):
    """Each invalid combination raises the reference's ``ValueError``,
    message for message."""
    errors = {}
    for name, (m, p, Engine, Store, _, core) in models.items():
        kw = dict(INVALID_KNOBS[case])
        if kw.pop("store", False):
            kw["prefix_store"] = Store(core.ObjectStore(str(tmp_path / name)), "ns")
        errors[name] = _error(lambda: Engine(m, p, page_size=PAGE, **kw))
    assert errors["port"] == errors["ref"]
    assert errors["port"][0] == "ValueError"


def test_serve_job_knob_errors_match_reference(tmp_path):
    """A job with ``prefix_store`` on a dense cache, and a prefill lease
    without a decode queue, are refused as the reference refuses them."""
    from types import SimpleNamespace

    jobs = [{"arch": "ds-paper-100m", "arch_overrides": "reduced", "device": "cpu",
             "prefix_store": True, "prompts": [[1, 2]]},
            {"arch": "ds-paper-100m", "arch_overrides": "reduced", "device": "cpu",
             "worker_role": "prefill", "request_queue": str(tmp_path / "rq.sqlite")}]
    errors = {}
    for name, mod, core in (("ref", jserve, jcore), ("port", tserve, tcore)):
        ctx = SimpleNamespace(store=core.ObjectStore(str(tmp_path / name)),
                              heartbeat=lambda progress=None: None, clock=core.VirtualClock())
        errors[name] = [_error(lambda job=job: mod.serve_payload(dict(job), ctx))
                        for job in jobs]
    assert errors["port"] == errors["ref"]
    assert all(e is not None and e[0] == "ValueError" for e in errors["port"])


# --------------------------- sweep races a handoff: the fallback ladder
def _age_tree(root: str, seconds: float) -> None:
    old = time.time() - seconds
    for dirpath, _, files in os.walk(root):
        for f in files:
            os.utime(os.path.join(dirpath, f), (old, old))


def test_sweep_mid_handoff_matches_reference(models, tmp_path):
    """The storage-mediated handoff at engine level, with the TTL sweep
    fired between handoff and admission: fresh pins protect the chain
    and hydration is a guaranteed hit; with the chain destroyed
    (``ttl 0``) the decode engine falls back and still emits the
    monolith's tokens.  Tokens, chain lengths and counters equal the
    reference's."""
    prompt = list(range(1, 12))
    results = {}
    for name, (m, p, Engine, Store, Req, core) in models.items():
        oracle = Engine(m, p, max_batch=2, max_len=32, prefill_chunk=4)
        oracle.submit([Req(uid="o", prompt=list(prompt), max_new_tokens=4)])
        want = oracle.run_to_completion()[0].output
        store = core.ObjectStore(str(tmp_path / name))

        def paged(role):
            return Engine(m, p, max_batch=2, max_len=32, prefill_chunk=4, cache_mode="paged",
                          page_size=PAGE, prefix_store=Store(store, "ns"), worker_role=role)

        pre = paged("prefill")
        pre.submit([Req(uid="h", prompt=list(prompt), max_new_tokens=4)])
        fin = pre.run_to_completion()
        chain = pre.cache_mgr.chain_keys_for(prompt)
        ps = Store(store, "ns")
        for k in chain:
            ps.pin(k)
        rec = {"uid": "h", "prompt": list(prompt), "output": [], "sample_stream": 0,
               "max_new_tokens": 4, "temperature": 0.0, "stop_token": None}
        _age_tree(os.path.join(store.root, "kvprefix"), 7200.0)
        protected = ps.sweep(3600.0)
        runs = []
        for _ in range(2):
            dec = paged("decode")
            dec.submit_handoff(dict(rec))
            out = dec.run_to_completion()[0].output
            s = dec.stats
            runs.append((out, s.handoffs_admitted, s.handoff_fallbacks,
                         s.prefix_store_pages_hydrated, s.hydration_fetch_ops,
                         s.prefix_store_bytes_fetched, dec.snapshot()["hydration_ticks"]))
            destroyed = ps.sweep(0.0)  # the store lies: the chain is gone
        results[name] = (want, fin[0].output, pre.stats.tokens_emitted,
                         pre.stats.decode_dispatches, len(chain), protected, destroyed, runs)
    assert results["port"] == results["ref"]
    want, pre_out, pre_tokens, pre_decodes, n_chain, protected, destroyed, runs = results["port"]
    assert pre_out == [] and pre_tokens == 0 and pre_decodes == 0
    assert n_chain == 2 and protected == 0 and destroyed > 0
    (out1, adm1, fb1, hyd1, ops1, bytes1, _), (out2, _, fb2, hyd2, _, _, _) = runs
    assert out1 == out2 == want
    assert adm1 == 1 and fb1 == 0 and hyd1 > 0 and ops1 > 0 and bytes1 > 0
    assert fb2 == 1 and hyd2 == 0


# --------------------------------------------- the payload scenarios
SHARED = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "device": "cpu", "run": "w",
          "max_new_tokens": 4, "max_len": 32, "max_batch": 2, "prefill_chunk": 4,
          "cache_mode": "paged", "page_size": PAGE, "prefix_cache": True, "prefix_store": True}
SYS_PROMPT = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
DISAGG_PROMPTS = [list(range(1, 11)), [1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 13], [21, 22, 23], [4, 5]]

SCENARIOS = {
    # tests/test_serve_stream.py::test_two_workers_share_prefix_pages_through_object_store
    "two_workers_share_prefix": dict(
        cfg={"cluster_machines": 2}, queues={},
        shared=SHARED,
        groups=lambda q: [{"prompts": [SYS_PROMPT + [31], SYS_PROMPT + [32]],
                           "output_prefix": "serve/w0"},
                          {"prompts": [SYS_PROMPT + [41], SYS_PROMPT + [42]],
                           "output_prefix": "serve/w1"}]),
    # tests/test_serve_stream.py::test_disaggregated_prefill_decode_roles_split_the_pipeline
    "prefill_decode_roles": dict(
        cfg={"cluster_machines": 2},
        queues={"rq": [{"uid": f"d{i}", "prompt": p, "max_new_tokens": 4}
                       for i, p in enumerate(DISAGG_PROMPTS)], "dq": []},
        shared=dict(SHARED, stream_slice_ticks=4, stream_idle_polls=200),
        groups=lambda q: [{"worker_role": "prefill", "request_queue": q["rq"],
                           "decode_queue": q["dq"], "expected_requests": 4,
                           "output_prefix": "serve/dpre"},
                          {"worker_role": "decode", "request_queue": q["dq"],
                           "expected_requests": 4, "output_prefix": "serve/ddec"}],
        max_ticks=400),
    # tests/test_elastic_serving.py::test_chaos_drill_is_deterministic_and_loses_nothing
    "revocation_drill": dict(
        cfg=dict(cluster_machines=1, cpu_shares=8192, memory_mb=16384,
                 idle_alarm_seconds=100_000.0, autoscale="queue", min_workers=1,
                 max_workers=2, autoscale_queue_per_worker=2,
                 autoscale_up_cooldown_seconds=TICK, autoscale_down_cooldown_seconds=3600.0),
        queues={"rq": [{"uid": f"q{i}", "prompt": SYS_PROMPT + [31 + i], "max_new_tokens": 12}
                       for i in range(6)]},
        shared=dict(SHARED, max_new_tokens=12, expected_requests=6, output_prefix="serve/drill",
                    stream_slice_ticks=2, stream_idle_polls=8, request_visibility=240.0,
                    request_max_receive_count=6),
        groups=lambda q: [{"request_queue": q["rq"]}, {"request_queue": q["rq"]}],
        fleet={"startup_seconds": TICK, "market_seed": 7}, max_receive=6, drill=True),
}


@pytest.fixture(scope="module")
def seed_weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "w", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def run_scenario(core, chaos_mod, serve_mod, root, spec):
    serve_mod.reset_serve_state()
    clk = core.VirtualClock()
    cfg = core.DSConfig(**{**dict(app_name="Store", payload="distributed-serve",
                                  cluster_machines=1, tasks_per_machine=1,
                                  machine_type=["sim.large"], machine_price=1.0,
                                  sqs_message_visibility=240.0, check_if_done=False,
                                  monitor_poll_seconds=TICK), **spec["cfg"]})
    rt = core.DSRuntime(cfg, store_root=str(root / "store"), clock=clk)
    rt.setup()
    paths, queues = {}, {}
    for name, bodies in spec["queues"].items():
        paths[name] = str(root / f"{name}.sqlite")
        queues[name] = core.DurableQueue(paths[name], default_visibility=240.0,
                                         max_receive_count=spec.get("max_receive", 3), clock=clk)
        if bodies:
            queues[name].send_batch(bodies)
    rt.submit_job(core.JobFile(shared=dict(spec["shared"]), groups=spec["groups"](paths)))
    rt.start_cluster(core.FleetFile(**spec.get("fleet", {"startup_seconds": 0.0})))
    chaos = None
    if spec.get("drill"):
        chaos = chaos_mod.ChaosMonkey.revocation_drill(
            rt.fleet, clk, seed=1234, n_revocations=1, start=3 * TICK, spacing=2 * TICK,
            notice_seconds=2 * TICK, store=rt.store, logs=rt.logs)
    summary = core.SimRunner(rt, tick_seconds=TICK, chaos=chaos).run(
        max_ticks=spec.get("max_ticks", 300))
    counts = {}
    for name, q in queues.items():
        counts[name] = q.counts()
        q.close()
    return {"objects": {i.key: _without_races(rt.store.get_json(i.key))
                        for i in rt.store.list("serve/")},
            "counts": counts, "summary": dataclasses.asdict(summary),
            "chaos": [dataclasses.asdict(r) for r in chaos.log] if chaos else None,
            "pages": len(list(rt.store.list("kvprefix/"))),
            "pins": len(list(rt.store.list("kvprefix-pins/")))}


def _without_races(obj):
    if isinstance(obj, dict):
        obj.pop("publish_dedup_hits", None)
    return obj


def _final_counters(objects, out):
    """Each worker's last counter record under ``out`` (its final summary
    supersedes its slice and drain records), summed."""
    mine = {key[len(out) + 1:]: value for key, value in objects.items()
            if key.startswith(out + "/")}
    recs = {}
    for name, value in mine.items():
        if name.startswith("leases/"):
            recs.setdefault(name[len("leases/"):-len(".json")], value)
    for name, value in mine.items():
        if name.startswith("RESULTS"):
            recs[name[len("RESULTS-"):-len(".json")] if "-" in name else "single"] = value
    total = {}
    for rec in recs.values():
        for k, v in rec.items():
            if isinstance(v, int):
                total[k] = total.get(k, 0) + v
    return total


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_payload_scenario_matches_reference(seed_weights, tmp_path, scenario):
    spec = SCENARIOS[scenario]
    runs = {}
    for name, core, chaos_mod, serve_mod in (("ref", jcore, jchaos, jserve),
                                             ("port", tcore, tchaos, tserve)):
        root = tmp_path / name
        shutil.copytree(seed_weights / "ckpt", root / "store" / "ckpt")
        runs[name] = run_scenario(core, chaos_mod, serve_mod, root, spec)
    want, got = runs["ref"], runs["port"]
    assert got["counts"] == want["counts"]
    assert all(c == {"visible": 0, "in_flight": 0, "dead": 0} for c in got["counts"].values())
    assert got["summary"] == want["summary"]
    assert got["chaos"] == want["chaos"]
    assert (got["pages"], got["pins"]) == (want["pages"], want["pins"])
    assert sorted(got["objects"]) == sorted(want["objects"])
    for key in want["objects"]:
        assert got["objects"][key] == want["objects"][key], key
    objs = got["objects"]
    if scenario == "two_workers_share_prefix":
        res = [objs[f"serve/w{i}/RESULTS.json"] for i in range(2)]
        assert sorted(r["prefix_store_pages_published"] for r in res) == [0, 2]
        assert sorted(r["prefix_store_pages_hydrated"] for r in res) == [0, 2]
        assert max(r["prompt_tokens_skipped"] for r in res) >= len(SYS_PROMPT)
    elif scenario == "prefill_decode_roles":
        pre, dec = _final_counters(objs, "serve/dpre"), _final_counters(objs, "serve/ddec")
        assert pre["handoffs_published"] == dec["handoffs_admitted"] == 4
        assert pre["tokens_emitted"] == 0 and dec["handoff_fallbacks"] == 0
        assert dec["prefix_store_pages_hydrated"] > 0 and dec["prefix_store_bytes_fetched"] > 0
        assert sum(k.startswith("serve/dpre/handoffs/") for k in objs) == 4
        assert got["pins"] > 0
    else:
        ctr = _final_counters(objs, "serve/drill")
        assert ctr["revocation_notices"] >= 1 and ctr["drain_requeued_requests"] >= 1
        assert ctr["prefix_store_pages_published"] > 0
        assert sum(k.startswith("serve/drill/requests/") for k in objs) == 6
