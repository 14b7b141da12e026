"""R3 — byte-determinism of engine-tick paths.

Motivating discipline: the bench gates and every recovery/chaos drill
assert *byte-identical* outputs across replays, preemption reruns,
checkpoint resumes and fleet A/B legs. That only holds because engine
ticks are pure functions of (seeded streams, admission order):
sampling uses ``(seed, stream, step)``-keyed draws, timing is counted
in engine ticks, and nothing on the tick path consults a wall clock or
an unseeded RNG.

The rule bans, in tick-role modules (``serving/engine.py``,
``scheduler.py``, ``sampling.py``, ``speculate.py``,
``cache_manager.py``, ``prefix_cache.py``):

- wall-clock / entropy calls: ``time.time``, ``time.monotonic``,
  ``time.perf_counter``, ``datetime.now``, ``os.urandom``,
  ``uuid.uuid4``;
- unseeded global RNGs: bare ``random.*`` and ``np.random.<draw>``
  (``np.random.default_rng(seed)`` and ``jax.random`` streams are
  fine — they are explicitly seeded);
- draws from torch's global generator (the port's addition to the
  reference's rule): ``torch.rand``, ``randn``, ``randint``,
  ``randperm``, ``multinomial``, ``bernoulli``, ``normal`` and the
  ``*_like`` forms, and the in-place ``Tensor.uniform_`` /
  ``normal_`` / ``exponential_`` / ``random_`` / ``bernoulli_``, each
  unless it passes ``generator=``.  ``torch.Generator`` is exempt, as
  ``np.random.default_rng`` is; the port's ticks sample through
  ``repro_torch.prng``'s threefry keys;
- iteration over an unordered ``set`` (``for x in some_set``, or a
  comprehension over one): Python sets iterate in hash order, which
  varies with insertion history and ``PYTHONHASHSEED``.  Membership
  tests and ``len()`` are fine; wrap iteration in ``sorted(...)``.
"""

from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis.rules.common import Rule, call_name, dotted_name

BANNED_CALLS = {
    "time.time": "wall clock",
    "time.monotonic": "wall clock",
    "time.perf_counter": "wall clock",
    "datetime.now": "wall clock",
    "datetime.datetime.now": "wall clock",
    "datetime.utcnow": "wall clock",
    "datetime.datetime.utcnow": "wall clock",
    "os.urandom": "entropy source",
    "uuid.uuid4": "entropy source",
    "uuid.uuid1": "entropy source",
}
# unseeded-global-RNG roots; np.random.default_rng(seed) is exempted
RNG_ROOTS = ("random.", "np.random.", "numpy.random.")
RNG_EXEMPT = {"np.random.default_rng", "numpy.random.default_rng",
              "random.Random"}
# torch's global-generator draws: ``torch.<draw>(...)`` and the in-place
# ``<tensor>.<draw>_(...)`` forms; a ``generator=`` keyword seeds them
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "rand_like", "randn_like", "randint_like",
})
TENSOR_DRAWS = frozenset({
    "uniform_", "normal_", "exponential_", "random_", "bernoulli_",
})


def _torch_global_draw(call: ast.Call) -> str:
    """The draw's name when ``call`` samples torch's global generator,
    "" otherwise (including any call that passes ``generator=``)."""
    if any(kw.arg == "generator" for kw in call.keywords):
        return ""
    name = call_name(call)
    if name.startswith("torch.") and name[len("torch."):] in TORCH_DRAWS:
        return name
    if isinstance(call.func, ast.Attribute) and call.func.attr in TENSOR_DRAWS:
        return name or f"Tensor.{call.func.attr}"
    return ""


def _set_names(func: ast.AST) -> Set[str]:
    """Names bound to a set within ``func`` (literal, ``set()`` call,
    set comprehension), plus ``self.<attr>`` assigned a set anywhere in
    the module's classes (tracked by the caller via prefix ``self.``)."""
    names: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if value is None:
                continue
            is_set = (
                isinstance(value, (ast.Set, ast.SetComp))
                or (isinstance(value, ast.Call) and call_name(value) == "set")
            )
            if not is_set:
                continue
            for t in targets:
                name = dotted_name(t)
                if name:
                    names.add(name)
    return names


class DeterminismRule(Rule):
    rule_id = "R3"
    title = ("no wall clock / unseeded RNG / unordered-set iteration on "
             "engine-tick paths (byte-identical replay is a bench gate)")

    def check_module(self, module, project):
        if "tick" not in module.roles:
            return
        set_names = _set_names(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name in BANNED_CALLS:
                    yield module.finding(
                        "R3", node,
                        f"{name}() is a {BANNED_CALLS[name]} — engine ticks "
                        "must be pure functions of seeded streams and "
                        "admission order (use the injected clock / the "
                        "(seed, stream, step) sampling keys)",
                    )
                elif (
                    any(name.startswith(r) for r in RNG_ROOTS)
                    and name not in RNG_EXEMPT
                ):
                    yield module.finding(
                        "R3", node,
                        f"{name}() draws from an unseeded global RNG — "
                        "replay cannot reproduce it; use an explicitly "
                        "seeded generator",
                    )
                elif draw := _torch_global_draw(node):
                    yield module.finding(
                        "R3", node,
                        f"{draw}() draws from torch's "
                        "global generator — replay cannot reproduce it; "
                        "pass generator= (a seeded torch.Generator) or "
                        "draw through repro_torch.prng's keys",
                    )
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if isinstance(it, ast.Call) and call_name(it) == "set":
                    yield module.finding(
                        "R3", it,
                        "iterating a set() directly — set order follows "
                        "PYTHONHASHSEED, not program state; wrap in "
                        "sorted(...)",
                    )
                elif dotted_name(it) in set_names:
                    yield module.finding(
                        "R3", it,
                        f"iterating set {dotted_name(it)!r} — unordered "
                        "iteration breaks byte-identical replay; wrap in "
                        "sorted(...)",
                    )
