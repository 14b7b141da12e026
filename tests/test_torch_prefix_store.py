"""The port's cross-host prefix store against the reference's, on the CPU.

The store alone: chunk keys and content digests equal the reference's
from one root, the framework tag on the root, f32 and bf16 pages
through pack/publish/fetch bit for bit, each kind of bad blob a counted
miss in both packages alike, the background publisher's retry, give-up
and pending-key dedup, the pin-aware TTL sweep, and the monitor's
teardown sweep keeping the same pages as the reference's
``PrefixStore.sweep``.

Through the engine and the ``distributed-serve`` payload on reduced
``ds-paper-100m`` (both packages from the reference's seed-0 weights):
a resume whose published generation pages are missing, corrupt or
mismatched falls down the recovery ladder to the same tokens and
counters as the reference's; a store holding the reference's pages for
the same job and namespace hydrates nothing into the port."""

import os
import shutil
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.serve as jserve
import repro_torch.core as tcore
import repro_torch.launch.serve as tserve
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.prefix_store import PrefixStore as JStore
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.core.chaos import ChaosEvent, ChaosMonkey
from repro_torch.core.fleet import SpotFleet
from repro_torch.core.monitor import Monitor
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_store import (
    AsyncPublisher,
    PrefixStore,
    device_page,
    host_dtype,
    host_page,
)

torch.set_num_threads(1)  # the test workers share the host's cores

STORES = {"ref": (JStore, jcore.ObjectStore), "port": (PrefixStore, tcore.ObjectStore)}


def _page_arrays():
    return {"k": np.arange(8, dtype=np.float32).reshape(2, 4),
            "v": np.ones((2, 4), np.float32)}


# ------------------------------------------------------------------ keys
def test_chain_keys_and_digest_match_reference_from_one_root(tmp_path):
    """From a given parent key both packages chain the same child keys
    and bind the same content digest; only the root differs, by the
    port's framework tag."""
    port = PrefixStore(tcore.ObjectStore(str(tmp_path / "p")), "ns")
    ref = JStore(jcore.ObjectStore(str(tmp_path / "r")), "ns")
    import hashlib

    assert ref.root_key() == hashlib.sha256(b"ns").hexdigest()
    assert port.root_key() == hashlib.sha256(b"repro_torch|ns").hexdigest()
    assert port.root_key() != ref.root_key()
    rng = np.random.default_rng(0)
    key_p = key_r = ref.root_key()
    for _ in range(4):
        chunk = rng.integers(0, 50_000, 8).tolist()
        key_p, key_r = port.child_key(key_p, chunk), ref.child_key(key_r, chunk)
        assert key_p == key_r
    arrays = {"k_pages": rng.standard_normal((2, 8, 2, 16)).astype(np.float32),
              "v_pages": rng.integers(-3000, 3000, (2, 8, 2, 16)).astype(np.int16)}
    assert PrefixStore.content_digest(key_p, arrays) == JStore.content_digest(key_r, arrays)
    # a blob either package packs is read back by the other
    assert JStore.unpack(PrefixStore.pack(arrays, key_p)).keys() == {
        "k_pages", "v_pages", "__digest__"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_page_round_trip_is_bit_exact(tmp_path, dtype):
    """Pool page slices pulled to host (bf16 as its int16 view), packed,
    published, fetched against the encoded template and written back
    equal the originals bit for bit."""
    ps = PrefixStore(tcore.ObjectStore(str(tmp_path)), "rt")
    gen = torch.Generator().manual_seed(0)
    pool = {n: torch.randn(2, 3, 8, 2, 16, generator=gen).to(dtype) for n in ("k_pages",
                                                                              "v_pages")}
    pool["k_pages"][0, 1, 0, 0, 0] = float("nan")  # payload bits, not values
    arrays = {n: host_page(leaf[:, 1]) for n, leaf in pool.items()}
    assert all(a.dtype == host_dtype(dtype) for a in arrays.values())
    key = ps.child_key(ps.root_key(), list(range(8)))
    ps.publish(key, arrays)
    like = {n: np.zeros(leaf.shape[:1] + leaf.shape[2:], host_dtype(dtype))
            for n, leaf in pool.items()}
    got = ps.fetch(key, like)
    assert got is not None and ps.hash_mismatches == 0
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for n, leaf in pool.items():
        back = torch.zeros_like(leaf)
        back[:, 2].copy_(device_page(got[n], dtype))
        assert back.dtype == dtype
        assert torch.equal(back[:, 2].view(ints), leaf[:, 1].view(ints))
    # a template of another dtype (a bf16 page against an f32 pool) misses
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert ps.fetch(key, {n: a.astype(host_dtype(other)) for n, a in like.items()}) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_published_page_is_the_pool_page_at_submit_time(tmp_path, dtype):
    """The background write publishes the pool page as it was when the
    engine submitted it, though the page is rewritten before the write
    lands (a reissued pool page).  On the CPU ``.cpu()`` returns the pool's
    own memory, so a pull that did not copy published whatever a later
    dispatch wrote there."""
    ps = PrefixStore(tcore.ObjectStore(str(tmp_path)), "snap")
    pool = torch.randn(2, 3, 8, 2, 16, generator=torch.Generator().manual_seed(1)).to(dtype)
    want = pool[:, 1].clone()
    gate = threading.Event()
    real_publish = ps.publish
    ps.publish = lambda key, arrs: (gate.wait(5.0), real_publish(key, arrs))
    pub = ps.publisher()
    key = ps.child_key(ps.root_key(), [1, 2])
    try:
        assert pub.submit(key, lambda: {"k_pages": host_page(pool[:, 1])})
        pool[:, 1] = 0  # reissued and rewritten while the write waits
    finally:
        gate.set()
        pub.close()
    got = ps.fetch(key, {"k_pages": np.zeros((2, 8, 2, 16), host_dtype(dtype))})
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(device_page(got["k_pages"], dtype).view(ints), want.view(ints))


def test_bad_blobs_are_counted_misses_like_the_reference(tmp_path):
    """Each package's store over the same sequence of bad blobs: a
    digest bound to another key, a digest-less blob and a truncated one
    (the chaos monkey's ``truncate_blob``) are misses, never hydrated;
    republishing heals the key.  Results, ``hash_mismatches``,
    ``fetch_ops`` and ``bytes_fetched`` equal the reference's step by
    step."""
    trails = {}
    for name, (Store, ObjStore) in STORES.items():
        objs = ObjStore(str(tmp_path / name))
        ps = Store(objs, "hash")
        like = _page_arrays()
        page = ps.child_key(ps.root_key(), [7, 8, 9])
        other = ps.child_key(ps.root_key(), [10, 11, 12])
        trail = []

        def probe(label):
            got = ps.fetch(page, like)
            trail.append((label, got is not None, ps.hash_mismatches, ps.fetch_ops,
                          ps.bytes_fetched))

        ps.publish(page, like)
        probe("clean")
        objs.put_bytes(ps._object_key(page), Store.pack(like, page_key=other))
        probe("other key's digest")
        objs.put_bytes(ps._object_key(page), Store.pack(like))
        probe("no digest")
        ps.publish(page, like)
        probe("republished")
        fleet = SpotFleet(tcore.FleetFile(startup_seconds=0.0), clock=tcore.VirtualClock(),
                          app_name="Blob")
        chaos = ChaosMonkey(fleet, tcore.VirtualClock(), store=tcore.ObjectStore(objs.root),
                            events=[ChaosEvent(kind="truncate_blob", at=0.0, victim=0)])
        assert [r.kind for r in chaos.tick()] == ["truncate_blob"]
        probe("truncated")
        objs.delete(ps._object_key(page))
        probe("missing")
        trails[name] = trail
    assert trails["port"] == trails["ref"]
    assert [t[1] for t in trails["port"]] == [True, False, False, True, False, False]
    assert trails["port"][-1][2] == 2  # two digest mismatches counted


# ------------------------------------------------------------ publisher
def test_async_publisher_retries_transient_faults(tmp_path):
    ps = PrefixStore(tcore.ObjectStore(str(tmp_path / "s")), "pub")
    page = ps.child_key(ps.root_key(), [1, 2, 3])
    real_publish, fails = ps.publish, {"n": 2}

    def flaky(page_key, arrays):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise ConnectionError("transient put")
        real_publish(page_key, arrays)

    ps.publish = flaky
    pub = AsyncPublisher(ps, max_attempts=4, retry_base=0.0, retry_cap=0.0)
    pub.submit(page, _page_arrays())
    pub.flush()
    assert pub.retries == 2 and pub.errors == 0
    assert ps.exists(page)
    assert ps.fetch(page, _page_arrays()) is not None
    pub.close()


def test_async_publisher_gives_up_after_max_attempts(tmp_path):
    ps = PrefixStore(tcore.ObjectStore(str(tmp_path / "s")), "pub")
    page = ps.child_key(ps.root_key(), [4, 5, 6])

    def always_down(page_key, arrays):
        raise ConnectionError("store down")

    ps.publish = always_down
    pub = AsyncPublisher(ps, max_attempts=3, retry_base=0.0, retry_cap=0.0)
    pub.submit(page, _page_arrays())
    pub.flush()
    # every attempt but the last is a retry; the final failure drops the
    # page (cold for other workers), never raises
    assert pub.retries == 2 and pub.errors == 1
    assert not ps.exists(page)
    pub.close()
    with pytest.raises(ValueError):
        AsyncPublisher(ps, max_attempts=0)


def test_async_publisher_dedups_pending_page_keys(tmp_path):
    ps = PrefixStore(tcore.ObjectStore(str(tmp_path / "store")), "ns")
    arrays = {"k": np.arange(8, dtype=np.float32)}
    gate = threading.Event()
    real_publish = ps.publish
    ps.publish = lambda key, arrs: (gate.wait(5.0), real_publish(key, arrs))
    pub = ps.publisher()
    try:
        key = "ab" * 32
        assert pub.submit(key, dict(arrays)) is True
        # the first write is gated in the worker thread, so the key is
        # still pending: the resubmit is dropped...
        assert pub.submit(key, dict(arrays)) is False
        assert pub.dedup_hits == 1
        # ...and a deduped callable submit never pulls a snapshot
        pulled = []
        assert pub.submit(key, lambda: pulled.append(1) or dict(arrays)) is False
        assert pub.dedup_hits == 2 and pulled == []
        assert pub.submit("cd" * 32, dict(arrays)) is True
        gate.set()
        pub.flush()
        assert ps.exists(key)
        # once landed the key is pending no more
        assert pub.submit(key, dict(arrays)) is True
        pub.flush()
        assert pub.dedup_hits == 2 and pub.errors == 0
    finally:
        gate.set()
        pub.close()
    assert pub._thread is None


# ----------------------------------------------------------------- sweep
def _age(root: str, key: str, seconds: float) -> None:
    old = time.time() - seconds
    os.utime(os.path.join(root, key), (old, old))


def test_sweep_honors_fresh_pins_and_collects_expired_markers(tmp_path):
    store = tcore.ObjectStore(str(tmp_path / "store"))
    ps = PrefixStore(store, "ns")
    arrays = {"k": np.arange(8, dtype=np.float32)}
    keep, drop = "aa" * 32, "bb" * 32
    ps.publish(keep, arrays)
    ps.publish(drop, arrays)
    ps.pin(keep)
    ps.pin(drop)
    for key in (keep, drop):
        _age(store.root, f"kvprefix/{key[:2]}/{key}", 7200.0)
    _age(store.root, f"kvprefix-pins/{drop[:2]}/{drop}", 7200.0)
    assert ps.sweep(3600.0) == 1  # pages only; markers are not counted
    assert ps.exists(keep), "a fresh pin must exempt an expired page"
    assert not ps.exists(drop)
    assert not store.exists(f"kvprefix-pins/{drop[:2]}/{drop}")
    assert store.exists(f"kvprefix-pins/{keep[:2]}/{keep}")
    # pins protect by TTL, not forever
    _age(store.root, f"kvprefix-pins/{keep[:2]}/{keep}", 7200.0)
    assert ps.sweep(3600.0) == 1
    assert not ps.exists(keep)


def test_monitor_teardown_sweep_keeps_what_the_reference_sweep_keeps(tmp_path):
    """Copies of one store, holding the port's (tagged) and the
    reference's (untagged) pages, fresh, expired and pinned, swept by the
    port's monitor and by the reference's ``PrefixStore.sweep``: the same
    pages and markers survive, and the same count is reported."""
    src = tcore.ObjectStore(str(tmp_path / "src"))
    stores = [PrefixStore(src, "ns"), JStore(jcore.ObjectStore(src.root), "ns")]
    arrays = _page_arrays()
    keys = []
    for i, ps in enumerate(stores):
        for j in range(4):
            key = ps.child_key(ps.root_key(), [i, j])
            ps.publish(key, arrays)
            keys.append(key)
    for key in keys[1:4] + keys[5:8]:  # all but one page of each package expired
        _age(src.root, f"kvprefix/{key[:2]}/{key}", 7200.0)
    stores[0].pin(keys[2])  # fresh pins on an expired page of each package
    stores[0].pin(keys[6])
    stores[0].pin(keys[3])  # an expired pin does not protect its page
    _age(src.root, f"kvprefix-pins/{keys[3][:2]}/{keys[3]}", 7200.0)
    shutil.copytree(src.root, tmp_path / "ref", copy_function=shutil.copy2)
    shutil.copytree(src.root, tmp_path / "port", copy_function=shutil.copy2)
    ref_swept = JStore(jcore.ObjectStore(str(tmp_path / "ref")), "x").sweep(3600.0)
    mon = Monitor.__new__(Monitor)
    mon.cfg = SimpleNamespace(kvprefix_ttl_seconds=3600.0)
    mon.store = tcore.ObjectStore(str(tmp_path / "port"))
    port_swept = mon._sweep_kvprefix()

    def left(root):
        return sorted(i.key for i in tcore.ObjectStore(root).list())

    assert port_swept == ref_swept == 4
    assert left(str(tmp_path / "port")) == left(str(tmp_path / "ref"))
    kept = {k.rsplit("/", 1)[-1] for k in left(str(tmp_path / "port"))
            if k.startswith("kvprefix/")}
    assert kept == {keys[0], keys[2], keys[4], keys[6]}
    mon.cfg = SimpleNamespace(kvprefix_ttl_seconds=None)
    assert mon._sweep_kvprefix() == 0  # not opted in: nothing swept


# --------------------------------------------- engine: the recovery ladder
@pytest.fixture(scope="module")
def engines():
    """Reference and port engine factories on the same seed-0 weights,
    each with a prefix store over a given object-store root."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(max_batch=2, max_len=32, prefill_chunk=4, rng_seed=7, cache_mode="paged",
              page_size=8, total_pages=10, prefix_cache=True)
    return {
        "ref": (lambda root: JEngine(jm, jp, prefix_store=JStore(
            jcore.ObjectStore(root), "ladder"), **kw), JRequest, jserve, jcore),
        "port": (lambda root: ServeEngine(m, p, device="cpu", prefix_store=PrefixStore(
            tcore.ObjectStore(root), "ladder"), **kw), Request, tserve, tcore),
    }


def _spoil(root: str, how: str, Store) -> None:
    """Spoil every published page: delete it, rewrite its leaves under
    the old digest (wrong content: the digest no longer matches), or
    rewrite it with a correct digest over leaves of another dtype (the
    template no longer matches)."""
    store = tcore.ObjectStore(root)
    for info in list(store.list("kvprefix/")):
        if how == "missing":
            store.delete(info.key)
            continue
        arrays = Store.unpack(store.get_bytes(info.key))
        if how == "corrupt":
            arrays["k_pages"] = arrays["k_pages"] + 1  # __digest__ kept as it was
            store.put_bytes(info.key, Store.pack(arrays))
        else:
            arrays.pop("__digest__")
            arrays = {n: a.astype(np.float64) for n, a in arrays.items()}
            store.put_bytes(info.key, Store.pack(arrays, info.key.rsplit("/", 1)[-1]))


def test_resume_over_spoiled_pages_matches_reference(engines, tmp_path):
    """A generation checkpointed mid-decode publishes its resident pages;
    a fresh engine resumes it from the sealed record.  With the pages
    intact the resume stitches them; missing, corrupt or mismatched
    pages are misses (corrupt ones counted as digest mismatches) and the
    resume chunk-prefills instead.  Every rung lands on the
    uninterrupted run's tokens, and tokens and counters equal the
    reference's."""
    results = {}
    for name, (make, Req, serve_mod, core) in engines.items():
        Store = JStore if name == "ref" else PrefixStore

        def req():
            return Req(uid="lad/0", prompt=list(range(20, 35)), max_new_tokens=6,
                       temperature=0.5)

        oracle = make(str(tmp_path / name / "oracle"))
        oracle.submit([req()])
        want = list(oracle.run_to_completion()[0].output)
        outcomes = []
        for how in ("intact", "missing", "corrupt", "mismatched"):
            root = str(tmp_path / name / how)
            a = make(root)
            a.submit([req()])
            while a.scheduler.slots[0].req is None or len(a.scheduler.slots[0].req.output) < 4:
                a.step()
            sealed = serve_mod._seal_checkpoint(a.checkpoint_slot(0))
            a.cache_mgr.flush_store()
            published = a.stats.prefix_store_pages_published
            if how != "intact":
                _spoil(root, how, Store)
            ctx = SimpleNamespace(store=core.ObjectStore(str(tmp_path / name / "ctx")),
                                  clock=core.VirtualClock())
            ctx.store.put_json("ck/lad~0.json", sealed)
            b = make(root)
            assert serve_mod._try_resume(b, ctx, "ck/", req()) is not None
            out = list(b.run_to_completion()[0].output)
            s = b.stats
            outcomes.append((how, published, out, s.prefix_store_pages_hydrated,
                             s.prefix_store_tokens_hydrated, s.prompt_tokens_skipped,
                             s.prompt_tokens_ingested, s.prefix_store_hash_mismatches,
                             s.hydration_fetch_ops, s.checkpoint_resumes, s.tokens_recovered))
        results[name] = (want, outcomes)
    assert results["port"] == results["ref"]
    want, outcomes = results["port"]
    assert all(o[2] == want for o in outcomes)
    by = {o[0]: o for o in outcomes}
    assert by["intact"][1] == 3 and by["intact"][3] == 3  # two full pages + the tail
    assert all(by[h][3] == 0 and by[h][5] == 0 for h in ("missing", "corrupt", "mismatched"))
    assert by["corrupt"][7] > 0 and by["mismatched"][7] == 0


# ------------------------------------- the reference's pages stay its own
@pytest.fixture(scope="module")
def seed_weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "w", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def test_reference_pages_never_hydrate_into_the_port(seed_weights, tmp_path):
    """The reference serves a static job with the store on, publishing
    its pages; the port then serves the same job, namespace and weights
    against the same store: it hydrates nothing (its framework-tagged
    keys never name the reference's pages), publishes its own, and its
    completions equal its run on an empty store."""
    sys_prompt = list(range(11, 27))
    job = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "run": "w", "device": "cpu",
           "max_new_tokens": 4, "max_len": 32, "max_batch": 2, "prefill_chunk": 4,
           "cache_mode": "paged", "page_size": 8, "prefix_store": True,
           "prefix_store_namespace": "one-namespace",
           "prompts": [sys_prompt + [31], sys_prompt + [32]]}
    results = {}
    for label, mod, root in (("ref", jserve, "shared"), ("port", tserve, "shared"),
                             ("port_alone", tserve, "alone")):
        store_root = tmp_path / root
        if not (store_root / "ckpt").exists():
            shutil.copytree(seed_weights / "ckpt", store_root / "ckpt")
        core = jcore if mod is jserve else tcore
        ctx = SimpleNamespace(store=core.ObjectStore(str(store_root)),
                              heartbeat=lambda progress=None: None, clock=core.VirtualClock())
        mod.serve_payload({**job, "output_prefix": f"serve/{label}"}, ctx)
        results[label] = ctx.store.get_json(f"serve/{label}/RESULTS.json")
    ref, port, alone = results["ref"], results["port"], results["port_alone"]
    assert ref["prefix_store_pages_published"] == 2
    assert port["prefix_store_pages_hydrated"] == 0 and port["prefix_store_bytes_fetched"] == 0
    assert port["prefix_store_pages_published"] == 2
    assert port["requests"] == alone["requests"]
    assert {k: v for k, v in port.items() if k != "requests"} == {
        k: v for k, v in alone.items() if k != "requests"}
    pages = list(tcore.ObjectStore(str(tmp_path / "shared")).list("kvprefix/"))
    assert len(pages) == 4  # both packages' two pages, side by side
