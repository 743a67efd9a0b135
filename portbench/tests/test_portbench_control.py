"""The control of each cell comes out not correct on the card: the
plain reference in float32 with TF32 products, in the program's place,
fails at least one of the cell's limits, where the program meets them
all.  Cut to a size a test run holds (fewer utterances, the cell's own
model and task); `control.py` reads it at the cell's own size."""

import pytest
import torch

from portbench import control, run

CELLS = ["xw1k.dense-b128", "xw1k.stream", "gmm10k.estep-b8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    bench, entry, wl, cfg = run.cell_spec(name)
    if wl["loop"] == "estep":       # two shards of the cell's own
        wl = dict(wl, lengths=dict(wl["lengths"], units=2))
    else:                           # one batch of 8 utterances
        wl = dict(wl, lengths=dict(wl["lengths"], count=8, units=1))
        if wl["loop"] == "dense":
            wl["batch"] = 8
    limits = wl["limits"]
    r = control.readings(name, 3000000003, 3.0, torch.device("cuda:0"),
                         spec=(bench, entry, wl, cfg))
    program = [(n, v) for n, v in r["program"] if n in limits]
    ctl = [(n, v) for n, v in r["control"] if n in limits]
    assert program and all(v <= limits[n] for n, v in program), r
    assert any(v > limits[n] for n, v in ctl), r
