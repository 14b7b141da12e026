"""The port's control plane (``repro_torch.core``) against the reference's
(``repro.core``) on the same scenario: the same ``DSConfig``, ``FleetFile``
(market seed) and ``JobFile`` run through each package's ``DSRuntime`` and
``SimRunner`` on a ``VirtualClock``, with one trivial payload registered
in each package's own registry.  The two runs must agree exactly: the
``RunSummary``, the queue counts, the dead letters, preemptions, idle
terminations, the autoscaler's decisions, the chaos log and every log
stream (tracebacks compared by their last line: they name each package's
own files).

Scenarios: a plain drain; ``CHECK_IF_DONE`` skips; ``NotReady`` retries;
the DLQ march after ``max_receive_count``; spot preemption of multi-tick
leases; autoscaling up and down; a seeded revocation drill.  A queue and
an object store written by one package are read by the other, in both
directions."""

import dataclasses

import pytest
import torch

import repro.core as jcore
import repro.core.chaos as jchaos
import repro.core.queue as jqueue
import repro.core.worker as jworker
import repro_torch.core as tcore
import repro_torch.core.chaos as tchaos
import repro_torch.core.queue as tqueue
import repro_torch.core.worker as tworker

torch.set_num_threads(1)  # the test workers share the host's cores

PAYLOAD = "ds-core-parity"
TICK = 30.0


def make_payload(worker):
    """A payload built from one package's worker module.  Each job counts
    its attempts in the store; ``poison`` always fails, ``not_ready``
    releases the first N attempts, ``units`` > 1 makes a lease that does
    one unit a claim and yields the rest (spanning ticks, so preemption
    and revocation land mid-job), and a revoked host drains by yielding."""

    def payload(job, ctx):
        name = job["name"]
        key = f"attempts/{name}.json"
        n = (ctx.store.get_json(key)["n"] if ctx.store.exists(key) else 0) + 1
        ctx.store.put_json(key, {"n": n})
        if job.get("poison"):
            raise RuntimeError(f"poison job {name}")
        if n <= job.get("not_ready", 0):
            raise worker.NotReady(f"{name} waits for attempt {n + 1}", retry_in=20.0)
        if ctx.revoked():
            raise worker.LeaseYield(f"{name}: revocation notice", retry_in=0.0)
        done_key = f"progress/{name}.json"
        done = (ctx.store.get_json(done_key)["units"] if ctx.store.exists(done_key) else 0) + 1
        ctx.heartbeat(progress=f"{name} unit {done}")
        ctx.report_progress({"kind": "batch", "job": name, "units": done})
        ctx.store.put_json(done_key, {"units": done})
        if done < job.get("units", 1):
            raise worker.LeaseYield(f"{name}: unit {done} of {job['units']}")
        ctx.store.put_text(f"{job['output_prefix']}/out.txt", f"{name} done after {n}")
        return {"name": name, "attempts": n}

    return payload


jworker.register_payload(PAYLOAD)(make_payload(jworker))
tworker.register_payload(PAYLOAD)(make_payload(tworker))


def _jobs(n, **extra):
    return [{"name": f"j{i}", "output_prefix": f"out/j{i}", **extra} for i in range(n)]


BASE_CFG = dict(app_name="CoreParity", payload=PAYLOAD, cluster_machines=2,
                tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                sqs_message_visibility=240.0, max_receive_count=3,
                check_if_done=False, monitor_poll_seconds=TICK)

SCENARIOS = {
    "plain_drain": dict(cfg={}, fleet={"startup_seconds": 0.0}, groups=_jobs(6)),
    "check_if_done": dict(cfg={"check_if_done": True, "expected_number_files": 1,
                               "min_file_size_bytes": 4},
                          fleet={"startup_seconds": 0.0}, groups=_jobs(5), done=(1, 3)),
    "not_ready_retry": dict(cfg={}, fleet={"startup_seconds": 0.0},
                            groups=_jobs(2) + [{"name": "late", "output_prefix": "out/late",
                                                "not_ready": 2}]),
    "dlq_march": dict(cfg={"max_receive_count": 3}, fleet={"startup_seconds": 0.0},
                      groups=_jobs(3) + [{"name": "bad", "output_prefix": "out/bad",
                                          "poison": True}]),
    "spot_preemption": dict(cfg={"cluster_machines": 3},
                            fleet={"startup_seconds": TICK, "market_seed": 5,
                                   "preemption_rate_per_hour": 40.0},
                            groups=_jobs(6, units=3)),
    "autoscale": dict(cfg={"cluster_machines": 1, "autoscale": "queue", "min_workers": 1,
                           "max_workers": 3, "autoscale_queue_per_worker": 2,
                           "autoscale_up_cooldown_seconds": TICK,
                           "autoscale_down_cooldown_seconds": 2 * TICK,
                           "cpu_shares": 8192, "memory_mb": 16384},
                      fleet={"startup_seconds": TICK, "market_seed": 3},
                      groups=_jobs(8, units=2)),
    "revocation_drill": dict(cfg={"cpu_shares": 8192, "memory_mb": 16384,
                                  "idle_alarm_seconds": 100_000.0},
                             fleet={"startup_seconds": TICK, "market_seed": 7},
                             groups=_jobs(4, units=4), drill=True),
}


def _events(logs):
    """Every log stream, tracebacks cut to their last line."""
    out = {}
    for stream in logs.streams():
        evs = []
        for e in logs.events(stream):
            e = dict(e)
            if "traceback" in e:
                e["traceback"] = e["traceback"].strip().splitlines()[-1]
            evs.append(e)
        out[stream] = evs
    return out


def run_scenario(core, chaos_mod, tmp, spec):
    clk = core.VirtualClock()
    cfg = core.DSConfig(**{**BASE_CFG, **spec["cfg"]})
    rt = core.DSRuntime(cfg, store_root=str(tmp / "store"), clock=clk)
    rt.setup()
    for i in spec.get("done", ()):
        rt.store.put_text(f"out/j{i}/out.txt", "already there")
    rt.submit_job(core.JobFile(shared={"kind": "parity"}, groups=spec["groups"]))
    rt.start_cluster(core.FleetFile(**spec["fleet"]))
    chaos = None
    if spec.get("drill"):
        chaos = chaos_mod.ChaosMonkey.revocation_drill(
            rt.fleet, clk, seed=11, n_revocations=1, start=3 * TICK, spacing=2 * TICK,
            notice_seconds=2 * TICK, store=rt.store, logs=rt.logs)
    runner = core.SimRunner(rt, tick_seconds=TICK, chaos=chaos)
    # the dead letters are read before each monitor poll: its teardown
    # purges them
    dead, poll = [], runner.monitor.tick

    def read_then_poll():
        dead[:] = [(m.body, m.receive_count) for m in rt.queue.dead_letters()]
        return poll()

    runner.monitor.tick = read_then_poll
    summary = runner.run(max_ticks=400)
    return {
        "summary": dataclasses.asdict(summary),
        "counts": rt.queue.counts(),
        "dead_letters": dead,
        "decisions": [dataclasses.asdict(d) for d in rt.autoscaler.decisions]
        if rt.autoscaler is not None else None,
        "chaos": [dataclasses.asdict(r) for r in chaos.log] if chaos is not None else None,
        "logs": _events(rt.logs),
        "outputs": {i.key: rt.store.get_text(i.key) for i in rt.store.list("out/")},
        "instances": sorted((i.id, i.state.value, i.terminate_reason)
                            for i in rt.fleet.instances.values()),
    }


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_control_plane_matches_reference(tmp_path, scenario):
    spec = SCENARIOS[scenario]
    want = run_scenario(jcore, jchaos, tmp_path / "ref", spec)
    got = run_scenario(tcore, tchaos, tmp_path / "port", spec)
    for key in want:
        assert got[key] == want[key], f"{scenario}: {key} differs"
    s = want["summary"]
    # each scenario exercises what it is named for
    if scenario == "check_if_done":
        assert s["jobs_skipped"] == 2 and s["jobs_done"] == 3
    elif scenario == "not_ready_retry":
        assert any("job not ready" in e["message"] for evs in want["logs"].values()
                   for e in evs)
        assert "out/late/out.txt" in want["outputs"]
    elif scenario == "dlq_march":
        assert [b["name"] for b, _ in want["dead_letters"]] == ["bad"]
        assert want["dead_letters"][0][1] == 3 and s["jobs_failed"] == 3
    elif scenario == "spot_preemption":
        assert s["preemptions"] >= 1
    elif scenario == "autoscale":
        applied = [d["desired"] for d in want["decisions"] if d["applied"]]
        assert max(applied) > 1 and applied[-1] < max(applied), want["decisions"]
    elif scenario == "revocation_drill":
        assert [c["kind"] for c in want["chaos"]][:1] == ["revoke"]
    assert len(want["outputs"]) == len([g for g in spec["groups"] if not g.get("poison")])


@pytest.mark.parametrize("writer,reader", [(jqueue, tqueue), (tqueue, jqueue)],
                         ids=["reference_to_port", "port_to_reference"])
def test_queue_file_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "q.sqlite")
    clk = jcore.VirtualClock()
    w = writer.DurableQueue(path, default_visibility=60.0, max_receive_count=2, clock=clk)
    w.send_batch([{"i": i} for i in range(4)])
    r = reader.DurableQueue(path, default_visibility=60.0, max_receive_count=2, clock=clk)
    got = r.receive_batch(2)
    assert [m.body for m in got] == [{"i": 0}, {"i": 1}]
    assert r.delete(got[0])
    assert w.counts() == {"visible": 2, "in_flight": 1, "dead": 0}
    clk.advance(61.0)  # the un-acked message resurfaces in the writer's view
    again = w.receive_batch(4)
    assert sorted(m.body["i"] for m in again) == [1, 2, 3]
    assert [m.receive_count for m in again if m.body["i"] == 1] == [2]
    clk.advance(61.0)
    assert r.receive() is not None  # the third receive of i=1 dead-letters it
    assert [m.body for m in w.dead_letters()] == [{"i": 1}]
    w.close()
    r.close()


@pytest.mark.parametrize("writer,reader", [(jcore, tcore), (tcore, jcore)],
                         ids=["reference_to_port", "port_to_reference"])
def test_object_store_opens_in_the_other_package(tmp_path, writer, reader):
    w = writer.ObjectStore(str(tmp_path))
    w.put_json("a/b.json", {"x": [1, 2]})
    w.put_text("a/c.txt", "hello")
    w.put_bytes("z/d.bin", b"\x00\x01")
    r = reader.ObjectStore(str(tmp_path))
    assert r.get_json("a/b.json") == {"x": [1, 2]}
    assert r.get_text("a/c.txt") == "hello" and r.get_bytes("z/d.bin") == b"\x00\x01"
    assert [(i.key, i.size) for i in r.list("a/")] == [(i.key, i.size) for i in w.list("a/")]
    r.delete("a/c.txt")
    assert not w.exists("a/c.txt")
