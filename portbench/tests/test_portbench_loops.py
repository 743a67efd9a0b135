"""Loops resolve by name, the table's first and then a file of their own
under `portbench/loops/`; `build_toolbox` sets the knobs a workload file
names, and the recognition cells' toolboxes are the ones they were."""

import dataclasses
import json
import sys

import pytest
import torch

from portbench import run
from portbench.harness import Laps
from portbench.loops import asr
from portbench.loops.estep import EStep
from portbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,cls", [("dense", asr.Dense),
                                      ("stream", asr.Stream),
                                      ("estep", EStep)])
def test_the_tabled_loops_resolve_to_their_classes(name, cls):
    assert run.loop_class(name) is cls


@pytest.fixture
def loop_dir(tmp_path, monkeypatch):
    """A `portbench/loops/` of its own beside the benchmark's other
    files: files written to it resolve as loop files do, `run.py` and
    `LOOPS` as they are."""
    import portbench.loops
    bench = tmp_path / "portbench"
    d = bench / "loops"
    d.mkdir(parents=True)
    for f in run.BENCH.iterdir():
        if f.name != "loops":
            (bench / f.name).symlink_to(f)
    monkeypatch.setattr(run, "BENCH", bench)
    monkeypatch.setattr(portbench.loops, "__path__",
                        [str(d), *portbench.loops.__path__])
    yield d
    for name in [m for m in sys.modules if m.startswith("portbench.loops.")
                 and (d / f"{m.rsplit('.', 1)[1]}.py").exists()]:
        del sys.modules[name]


def test_a_loop_file_resolves_by_its_cell(loop_dir):
    (loop_dir / "probe.py").write_text(
        "from portbench.loops.asr import Dense\n\n\n"
        "class Probe(Dense):\n    pass\n\n\nCELL = Probe\n")
    assert "probe" not in run.LOOPS
    cls = run.loop_class("probe")
    assert cls.__name__ == "Probe" and issubclass(cls, asr.Dense)


def test_a_loop_file_with_a_task_of_its_own_drives_a_run(loop_dir, capsys):
    """A loop file that hands `Dense` another task (here a bigram over
    24 words) runs through `run.main` and is checked against its own
    planted words."""
    (loop_dir / "bigram.py").write_text(
        "from portbench.loops.asr import Dense\n"
        "from portbench.traffic.task import decode_task\n\n\n"
        "class Bigram(Dense):\n"
        "    def __init__(self, cfg, wl, seed, device, workdir):\n"
        "        task = decode_task(**dict(cfg['task'], num_words=24,\n"
        "                                  order=2))\n"
        "        super().__init__(cfg, wl, seed, device, workdir, task)\n"
        "        assert len(self.data.task['words']) == 24\n\n\n"
        "CELL = Bigram\n")
    bench, entry, wl, cfg = tiny_spec("xw1k.dense-b128")
    rc = run.main(["--workload", "xw1k.dense-b128", "--seed", "2147483659",
                   "--seconds", "0.5", "--trace", "0"], device=CPU,
                  spec=(bench, entry, dict(wl, loop="bigram"), cfg))
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True and res["attempted"] > 0


def test_a_loop_file_without_a_cell_fails_with_its_name(loop_dir):
    (loop_dir / "nocell.py").write_text("X = 1\n")
    with pytest.raises(SystemExit, match="unknown loop 'nocell'"):
        run.loop_class("nocell")


@pytest.mark.parametrize("name", ["nosuchloop", "asr", "asr.Dense",
                                  "../run", ""])
def test_an_unknown_loop_fails_with_its_name(name):
    with pytest.raises(SystemExit, match=f"unknown loop {name!r}"):
        run.loop_class(name)


def test_an_unknown_loop_stops_a_run_before_set_up(capsys):
    bench, entry, wl, cfg = tiny_spec("xw1k.dense-b128")
    with pytest.raises(SystemExit, match="nosuchloop"):
        run.main(["--workload", "xw1k.dense-b128", "--seed", "1",
                  "--seconds", "0.1"], device=CPU,
                 spec=(bench, entry, dict(wl, loop="nosuchloop"), cfg))
    assert capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    _, _, wl, cfg = tiny_spec("xw1k.dense-b128", utterances=2)
    return asr.AsrData(cfg, wl, 5, CPU, str(tmp_path_factory.mktemp("am")),
                       Laps())


def toolbox_before(data, wl, device):
    """`build_toolbox` as it was before the optional word boundary."""
    from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
    s = wl["search"]
    t = Toolbox(data.paths["ph"], data.paths["dur"], device=device)
    t.set_optional_short_silence(s["optional_short_silence"])
    t.set_require_sentence_end(s["require_sentence_end"])
    t.lex_read(data.paths["lexicon"])
    t.ngram_read(data.paths["lm"])
    t.set_global_beam(s["beam"])
    t.set_token_limit(s["tokens"])
    t.set_lm_scale(s["lm_scale"])
    t.set_duration_scale(s["duration_scale"])
    t.config.num_records = s["records"]
    return t


@pytest.mark.parametrize("cell", ["xw1k.dense-b128", "xw1k.stream"])
def test_the_recognition_cells_build_the_same_toolbox(data, cell):
    wl = run.cell_spec(cell)[2]
    new, old = (f(data, wl, CPU) for f in (asr.build_toolbox,
                                           toolbox_before))
    assert dataclasses.asdict(new.config) == dataclasses.asdict(old.config)
    for key in ("_word_boundary", "_silence_is_word",
                "_optional_short_silence", "_sentence_start",
                "_sentence_end"):
        assert getattr(new, key) == getattr(old, key), key
    assert new.tree.num_nodes == old.tree.num_nodes


def test_the_word_boundary_reaches_its_field(data):
    wl = run.cell_spec("xw1k.dense-b128")[2]
    base = asr.build_toolbox(data, wl, CPU).config
    wl = dict(wl, search=dict(wl["search"], word_boundary="<w>"))
    t = asr.build_toolbox(data, wl, CPU)
    assert base.word_boundary == "" and t.config.word_boundary == "<w>"
    assert dataclasses.replace(t.config, word_boundary="") == base
    # set before the lexicon was read, with silences as words
    assert t._word_boundary == "<w>" and t._silence_is_word
