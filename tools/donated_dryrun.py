"""The dry run's count of a train cell traced functional and donated, on the
card's layout (one rank, meta tensors: no device, no device number).

    PYTHONPATH=src python tools/donated_dryrun.py   # the CPU, ~5 s

The cell is ds-paper-100m's ``train_4k`` at d 1024, d_ff 8,192, 2 layers,
cut to 2 rows of 512 tokens in 2 microbatches (the functional step put
in the donated one's place for the first line), where the update, not the
backward, holds the peak (``tests/test_torch_dryrun.py`` holds the same
cell).  Prints one JSON line per form: the state's bytes (parameters and
optimizer state), the bytes of the step's outputs that are its inputs
(``alias_bytes``) and the peak of temporaries.
"""
import dataclasses
import json

from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves

WIDE_TRAIN = dict(n_layers=2, d_model=1024, n_heads=8, head_dim=128, n_kv_heads=4, d_ff=8192,
                  vocab_size=2048)


def main() -> None:
    SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"], global_batch=2, seq_len=512)
    cfg = dataclasses.replace(get_arch("ds-paper-100m"), **WIDE_TRAIN)
    mesh = {"data": 1, "model": 1}
    donating = cells.make_train_step
    for donate in (False, True):
        # the cell as built (donated), or with the functional step in its place
        cells.make_train_step = donating if donate else (
            lambda model, tcfg, donate: make_train_step(model, tcfg))
        cell = cells.build_cell("ds-paper-100m", "train_4k", mesh, cfg_override=cfg,
                                microbatches=2)
        state = sum(t.numel() * t.element_size() for t in tree_leaves(cell.args[:2])
                    if hasattr(t, "numel"))
        traced = cells.trace_cell(cell, mesh)
        print(json.dumps({"donated": donate, "state_bytes": state,
                          "alias_bytes": traced.alias_bytes,
                          "peak_temp_bytes": traced.recorder.trace.peak_temp_bytes}), flush=True)


if __name__ == "__main__":
    main()
