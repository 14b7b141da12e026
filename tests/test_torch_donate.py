"""The donated train step (``make_train_step(..., donate=True)``, the
counterpart of the reference's ``jax.jit(train_step, donate_argnums=(0,
1))``) held bit for bit to the port's functional step, on the CPU:

- two steps of every one of the reference's eleven configs at reduced
  size, with f32 and with int8 moments: every parameter, every moment
  (an int8 moment's ``q`` and ``scale``), the step count and the metrics
  equal, and the trees the donated step returns are the ones passed in;
- ``master_fp32`` over bf16 parameters, and 2 microbatches under each
  accumulation dtype (int8 with its stochastic rounding);
- ``adamw_update_`` cutting a leaf into slices of its first dimension
  (down to a row) gives the bits of the whole leaf and of
  ``adamw_update``;
- a tree whose leaves share storage is refused before anything is
  written.

AdamW over DTensors is held in ``test_torch_distribution.py``, the donated
``distributed-train`` payload against the reference's in
``test_torch_family_payloads.py``."""

import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import _REGISTRY
from repro_torch.models import Model, ModelRuntime
from repro_torch.train import optimizer as topt
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.steps import TrainStepConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

torch.set_num_threads(1)  # the test workers share the host's cores

SCHED = topt.Schedule(peak_lr=1e-3, warmup_steps=2, total_steps=8)


def clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def containers(tree):
    """New containers over the same leaves: what the update in place
    empties, leaving ``tree`` whole."""
    return tree_map(lambda t: t, tree)


def assert_bit_equal(got, want, what: str) -> None:
    paths = [p for p, _ in tree_leaves_with_path(want)]
    assert [p for p, _ in tree_leaves_with_path(got)] == paths
    for (path, a), b in zip(tree_leaves_with_path(got), tree_leaves(want)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{what} {path}"
        else:
            assert a == b, f"{what} {path}"


def run_both(model, tcfg: TrainStepConfig, params, steps: int = 2, seq_len: int = 16,
             batch: int = 4):
    """``steps`` functional steps and ``steps`` donated ones from copies of
    ``params``; the donated step's returned trees must be the ones it was
    given."""
    data = SyntheticLM(model.cfg, DataConfig(seq_len=seq_len, global_batch=batch), device="cpu")
    out = {}
    for donate in (False, True):
        step = make_train_step(model, tcfg, donate=donate)
        ps = clone(params)
        opt = topt.init_opt_state(ps, tcfg.opt)
        mets = []
        for i in range(steps):
            new_ps, new_opt, met = step(ps, opt, data.batch(i), prng.PRNGKey(i, device="cpu"))
            assert (new_ps is ps and new_opt is opt) == donate
            ps, opt = new_ps, new_opt
            mets.append({k: float(v) for k, v in met.items()})
        out[donate] = ps, opt, mets
    return out


def assert_donated_is_functional(out) -> None:
    (fp, fo, fm), (dp, do, dm) = out[False], out[True]
    assert fm == dm
    assert_bit_equal(dp, fp, "params")
    assert_bit_equal(do, fo, "opt_state")
    assert do["step"] == 2


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("arch", sorted(_REGISTRY))
def test_donated_step_is_the_functional_step(arch, moments):
    assert len(_REGISTRY) == 11
    model = Model(reduced(get_arch(arch)))
    tcfg = TrainStepConfig(opt=topt.AdamWConfig(schedule=SCHED, moments_dtype=moments))
    assert_donated_is_functional(run_both(model, tcfg, model.init(0, device="cpu")))


VARIANTS = {  # name -> (runtime dtype, TrainStepConfig keys, AdamWConfig keys)
    "master_fp32_bf16": (torch.bfloat16, {}, {"master_fp32": True}),
    "master_fp32_bf16_int8_moments": (torch.bfloat16, {},
                                      {"master_fp32": True, "moments_dtype": "int8"}),
    "microbatches2_f32": (torch.float32, {"microbatches": 2, "accum_dtype": "f32"}, {}),
    "microbatches2_bf16": (torch.float32, {"microbatches": 2, "accum_dtype": "bf16"}, {}),
    "microbatches2_int8": (torch.float32, {"microbatches": 2, "accum_dtype": "int8"}, {}),
    "microbatches2_int8_moments_int8": (torch.float32,
                                        {"microbatches": 2, "accum_dtype": "int8"},
                                        {"moments_dtype": "int8"}),
}


@pytest.mark.parametrize("arch", ["ds-paper-100m", "mixtral-8x7b"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_donated_step_variants(variant, arch):
    dtype, step_keys, opt_keys = VARIANTS[variant]
    model = Model(reduced(get_arch(arch)), ModelRuntime(dtype=dtype))
    tcfg = TrainStepConfig(**step_keys, opt=topt.AdamWConfig(schedule=SCHED, **opt_keys))
    params = model.init(0, device="cpu")
    assert params["embed"].dtype == dtype
    assert_donated_is_functional(run_both(model, tcfg, params))


def _opt_case(moments: str, master: bool):
    """A tree with a leaf large enough to slice, a 1-D and a 0-d leaf, in
    an order ``tree_leaves`` sorts, one state stepped already."""
    g = torch.Generator().manual_seed(4)
    dtype = torch.bfloat16 if master else torch.float32

    def draw(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    params = {"z": draw(3, 260), "big": [{"w": draw(37, 5, 260)}, {"w": draw(11, 300)}],
              "bias": draw(300), "gain": draw()}
    cfg = topt.AdamWConfig(schedule=SCHED, moments_dtype=moments, master_fp32=master)
    state = topt.init_opt_state(params, cfg)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    params, state, _ = topt.adamw_update(params, grads, state, cfg)
    grads = tree_map(lambda t: 3 * torch.randn(t.shape, generator=g), params)
    return params, grads, state, cfg


@pytest.mark.parametrize("slice_elems", [1, 260, 1300, 1 << 26])
@pytest.mark.parametrize("moments,master", [("f32", False), ("int8", False), ("f32", True),
                                            ("int8", True)])
def test_slicing_a_leaf_gives_the_same_bits(moments, master, slice_elems):
    params, grads, state, cfg = _opt_case(moments, master)
    want = topt.adamw_update(params, grads, state, cfg)
    if slice_elems < 1 << 26:
        assert len(topt._row_slices(params["big"][0]["w"], slice_elems)) > 1
    got = topt.adamw_update_(clone(params), containers(grads), clone(state), cfg,
                             slice_elems=slice_elems)
    assert_bit_equal(got[0], want[0], "params")
    assert_bit_equal(got[1], want[1], "opt_state")
    assert torch.equal(got[2]["grad_norm"], want[2]["grad_norm"])


def test_update_in_place_drops_each_gradient():
    """The gradient tree's containers are emptied as the walk goes, so
    the update holds the last reference to each gradient once its leaf is
    written."""
    params, grads, state, cfg = _opt_case("int8", False)
    topt.adamw_update_(params, grads, state, cfg)
    assert grads == {"z": None, "big": [{"w": None}, {"w": None}], "bias": None, "gain": None}


ALIASES = {
    "view_of_another_leaf": lambda p: {**p, "head": p["embed"][:4]},
    "one_tensor_twice": lambda p: {**p, "head": p["embed"]},
    "tied_transpose": lambda p: {**p, "head": p["embed"].T},
}


@pytest.mark.parametrize("alias", list(ALIASES))
def test_aliased_leaves_are_refused(alias):
    g = torch.Generator().manual_seed(1)
    params = ALIASES[alias]({"embed": torch.randn(8, 6, generator=g),
                             "w": torch.randn(6, 6, generator=g)})
    cfg = topt.AdamWConfig(schedule=SCHED)
    state = topt.init_opt_state(params, cfg)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    before = clone(params)
    with pytest.raises(ValueError, match="share storage"):
        topt.adamw_update_(params, grads, state, cfg)
    assert_bit_equal(params, before, "params")  # nothing written
    assert state["step"] == 0
    topt.adamw_update(params, grads, state, cfg)  # the functional update takes it
