"""PyTorch port, scale-out and tracing: `parallel/` (the data x model EM
step on torch.distributed), `utils/profiling.py` and
`__graft_entry_torch__.py`, each against the JAX package on the same
numpy inputs (CPU).  One counterpart for each case of
`tests/test_parallel.py`, at its tolerances: the step on a 4 x 2 gloo
world (each rank passing its data block) against JAX's on its 4 x 2
virtual mesh and against the port's single-process `chain_stats` plus
the ML update, as are the recipe's disjoint `process_shard` batches
(ll rel 1e-4, means and covars rtol = atol = 2e-3, log weights atol
2e-3); the (8, 1), (4, 2)
and (2, 4) layouts against each other (1e-4, ll rel 1e-5); three EM
steps; `initialize`, `global_mesh` and `process_shard`; the dense
decode split over 8 ranks against JAX's unsharded one (words identical,
log-probs rel 1e-5).

The multi-rank cases run in one 8-rank world of spawned CPU processes
(`distributed.cpu_world`, gloo, a FileStore rendezvous), started once
for the module.  The ranks re-import this module, so it imports jax
and the JAX package inside the tests only, and each rank asserts that
jax stayed out of its process."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry_torch__ as t_entry
from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, quantize_lna_u16
from aaltoasr_tpu_torch.parallel import distributed
from aaltoasr_tpu_torch.synth import (
    MFCC_CFG, exact_features, exact_lna_codes, random_model)
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.utils import profiling
from aaltoasr_tpu_torch.utils.profiling import device_trace

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ((8, 1), (4, 2), (2, 4))
DIST_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID", "SLURM_PROCID", "TPU_WORKER_HOSTNAMES",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK")


def _data_block(mesh, feats, graphs, n_frames, shift=0):
    """This rank's block of a batch: contiguous blocks in data
    coordinate order, as JAX's P("data") splits it (``shift`` hands a
    model rank another data coordinate's block)."""
    n = mesh.size(0)
    d = (mesh.get_local_rank("data") + shift) % n
    b = feats.shape[0] // n
    sl = slice(d * b, (d + 1) * b)
    return feats[sl], {k: v[sl] for k, v in graphs.items()}, n_frames[sl]


def _run_steps(inputs, n_data, n_model, steps=1, minvar=0.1):
    from aaltoasr_tpu_torch.parallel.mesh import (
        make_mesh, sharded_train_step)
    params, feats, graphs, n_frames, slots = inputs
    mesh = make_mesh(n_data=n_data, n_model=n_model, device="cpu")
    step = sharded_train_step(mesh, slots, minvar=minvar)
    mine = _data_block(mesh, feats, graphs, n_frames)
    lls = []
    for _ in range(steps):
        params, ll = step(params, *mine)
        lls.append(float(ll))
    return {k: v.numpy() for k, v in params.items()}, lls


def _recipe_step(inputs, n_utts, n_data, n_model, by_mesh):
    """The multi-process recipe: each rank takes its `process_shard` of
    a recipe of the batch's first ``n_utts`` utterances (over the mesh's
    data axis, or over the world when ``by_mesh`` is false) and steps on
    those utterances alone."""
    from aaltoasr_tpu_torch.parallel.mesh import (
        make_mesh, sharded_train_step)
    params, feats, graphs, n_frames, slots = inputs
    mesh = make_mesh(n_data=n_data, n_model=n_model, device="cpu")
    recipe = Recipe.read([f"audio=/c/u{i}.wav" for i in range(n_utts)])
    shard = distributed.process_shard(recipe, mesh=mesh if by_mesh
                                      else None)
    idx = [int(Path(r.audio_path).stem[1:]) for r in shard]
    params, ll = sharded_train_step(mesh, slots, minvar=0.01)(
        params, feats[idx], {k: v[idx] for k, v in graphs.items()},
        n_frames[idx])
    return {k: v.numpy() for k, v in params.items()}, float(ll), idx


def _refusal(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def _world_job(cases):
    """One rank of the 8-rank world: every step case, the global mesh,
    `replicate`, the refusals of shapes that do not split, and this
    rank's block of the dense decode (all blocks gathered)."""
    import torch.distributed as dist
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
    from aaltoasr_tpu_torch.parallel.mesh import (
        make_mesh, replicate, sharded_train_step)
    out = {"match": _run_steps(cases["match"], 4, 2, minvar=0.01),
           "recipe": [_recipe_step(cases["match"], 7, 4, 2, True),
                      _recipe_step(cases["match"], 8, 8, 1, False)],
           "layouts": [_run_steps(cases["layout"], nd, nm)
                       for nd, nm in LAYOUTS],
           "em": _run_steps(cases["em"], 4, 2, steps=3, minvar=0.01)}
    mesh = distributed.global_mesh(n_model=2, device="cpu")
    out["mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names,
                   mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    rank = dist.get_rank()
    out["replicate"] = {k: v.tolist() for k, v in replicate(
        {"a": np.full(3, rank, np.int64), "b": torch.full((2,), rank + 0.5)},
        mesh).items()}
    params, feats, graphs, n_frames, slots = cases["match"]
    step = sharded_train_step(mesh, slots)
    mine = _data_block(mesh, feats, graphs, n_frames)
    out["refusals"] = [
        _refusal(make_mesh, 3, 2, "cpu"),
        _refusal(step, params, *_data_block(
            mesh, feats, graphs, n_frames,
            shift=mesh.get_local_rank("model"))),
        _refusal(step, {**params, "means": params["means"][:7],
                        "covars": params["covars"][:7]}, *mine)]
    tree, fsa, model, cfg, pad, n = cases["decode"]
    dense = DenseBeamSearch(tree, fsa, model, cfg, device="cpu")
    world = dist.get_world_size()
    b = pad.shape[0] // world
    mine = [(r.words, r.log_prob) for r in dense.decode_batch(
        pad[rank * b:(rank + 1) * b], n[rank * b:(rank + 1) * b],
        lattice=False)]
    blocks = [None] * world
    dist.all_gather_object(blocks, mine)
    out["decode"] = [x for block in blocks for x in block]
    assert "jax" not in sys.modules
    return out


def _decode_case():
    """`test_dense_decode_sharded_over_batch`'s task and padded batch."""
    from aaltoasr_tpu.decoder.search import SearchConfig
    from tests.test_decoder import make_decode_task, synth_obs
    model, tree, fsa = make_decode_task()
    cfg = SearchConfig(num_tokens=256, num_records=16, beam=1e9,
                       lm_scale=1.0)
    seqs = [["a", "b", "b", "a"], ["c", "a", "_"],
            ["b", "a", "c", "a"], ["a", "b", "_"]] * 2
    obs_list = [synth_obs(tree, model, s, seed=i)
                for i, s in enumerate(seqs)]
    T = max(o.shape[0] for o in obs_list)
    B = len(obs_list)
    pad = np.full((B, T, obs_list[0].shape[1]), -100.0, np.float32)
    n = np.zeros(B, np.int32)
    for i, o in enumerate(obs_list):
        pad[i, :o.shape[0]] = o
        n[i] = o.shape[0]
    return (model, tree, fsa, cfg, pad, n)


@pytest.fixture(scope="module")
def world():
    """The cases' numpy inputs (made by `tests/test_parallel.py`'s
    helpers), the JAX decode task, and every rank's results."""
    from aaltoasr_tpu.models.hmm import TransitionTable
    from tests.test_parallel import make_batch, pool_params
    from tests.test_train import three_state_model

    def case(model_seed, B, T, seed):
        model = three_state_model(seed=model_seed)
        table = TransitionTable.from_model(model)
        feats, graphs, n_frames = make_batch(model, table, B=B, T=T,
                                             seed=seed)
        params, _ = pool_params(model)
        return model, (params, feats, graphs, n_frames, table.num_slots)

    models, cases = {}, {}
    for name, args in (("match", (0, 8, 24, 0)), ("layout", (0, 8, 16, 2)),
                       ("em", (7, 8, 32, 3))):
        models[name], cases[name] = case(*args)
    jdec = _decode_case()
    model, tree, fsa, cfg, pad, n = jdec
    cases["decode"] = (convert.prefix_tree(tree), convert.ngram_fsa(fsa),
                       convert.hmm_model(model), convert.search_config(cfg),
                       pad, n)
    results = distributed.cpu_world(8, _world_job, cases, timeout=300)
    return {"models": models, "cases": cases, "jdecode": jdec,
            "ranks": results}


def _assert_params_close(ours, ref, tol=2e-3, logw_tol=2e-3):
    for k in ("means", "covars"):
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=tol,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(ours["comp_logw"],
                               np.asarray(ref["comp_logw"]), atol=logw_tol)
    np.testing.assert_array_equal(ours["comp_idx"],
                                  np.asarray(ref["comp_idx"]))


def test_step_matches_jax(world):
    """`test_8dev_matches_single_device`'s batch: the 4 x 2 world against
    JAX's `sharded_train_step` on its 4 x 2 virtual mesh; every rank
    returns the same global parameters."""
    from aaltoasr_tpu.parallel.mesh import make_mesh as j_make_mesh
    from aaltoasr_tpu.parallel.mesh import sharded_train_step as j_step
    params, feats, graphs, n_frames, slots = world["cases"]["match"]
    step = j_step(j_make_mesh(n_data=4, n_model=2), slots, minvar=0.01)
    jparams, jll = step(params, feats, graphs, n_frames)
    ours, lls = world["ranks"][0]["match"]
    assert lls[0] == pytest.approx(float(jll), rel=1e-4)
    _assert_params_close(ours, jparams)
    for other in world["ranks"][1:]:
        assert other["match"][1] == lls
        for k in ours:
            np.testing.assert_array_equal(other["match"][0][k], ours[k])


def _ml_update(params, st, minvar):
    """The ML update of `sharded_train_step`, in float64 numpy."""
    G = params["means"].shape[0]
    gamma = st["gamma"][:G]
    has = gamma > 0
    safe = np.where(has, gamma, 1.0)[:, None]
    mean = st["mean_acc"][:G] / safe
    cov = np.maximum(st["sec_acc"][:G] / safe - mean ** 2, minvar)
    mg = st["mix_gamma"]
    tot = mg.sum(1, keepdims=True)
    logw = params["comp_logw"]
    w = np.where(tot > 0, mg / np.maximum(tot, 1e-30), np.exp(logw))
    new_logw = np.where(logw <= -1e30 / 2, -1e30,
                        np.log(np.maximum(w, 1e-30)))
    return {"means": np.where(has[:, None], mean, params["means"]),
            "covars": np.where(has[:, None], cov, params["covars"]),
            "comp_idx": params["comp_idx"], "comp_logw": new_logw}


def _port_step(world, n_utts):
    """The port's own single-process E-step (`chain_stats` over the
    batch's first ``n_utts`` utterances, summed) plus the ML update."""
    params, feats, graphs, n_frames, slots = world["cases"]["match"]
    scorer = GmmScorer.from_model(
        convert.hmm_model(world["models"]["match"]), device="cpu")
    g = estep.stack_graphs([{k: v[b] for k, v in graphs.items()}
                            for b in range(n_utts)], "cpu")
    st = estep.chain_stats(scorer, torch.as_tensor(feats[:n_utts]), g,
                           torch.as_tensor(n_frames[:n_utts]), slots)
    st = {k: v.double().sum(0).numpy() for k, v in st.items()}
    return _ml_update(params, st, minvar=0.01), st["log_likelihood"]


def test_step_matches_port_chain_stats(world):
    """The world's step against the port's own single-process E-step
    plus the ML update."""
    ref, ref_ll = _port_step(world, 8)
    ours, lls = world["ranks"][0]["match"]
    assert lls[0] == pytest.approx(ref_ll, rel=1e-4)
    _assert_params_close(ours, ref)


@pytest.mark.parametrize("which, n_utts, shards", [
    (0, 7, [[0, 1], [2, 3], [4, 5], [6]]),
    (1, 8, [[i] for i in range(8)]),
], ids=["4x2-process_shard-by-mesh", "8x1-process_shard-by-rank"])
def test_recipe_shards_match_port_chain_stats(world, which, n_utts, shards):
    """The multi-process recipe: disjoint `process_shard` batches (one
    per data coordinate, uneven over 4 x 2; one per rank over 8 x 1)
    stepped together give the unsharded E-step plus the ML update over
    every utterance, on every rank."""
    ref, ref_ll = _port_step(world, n_utts)
    n_model = 2 if which == 0 else 1
    for rank, res in enumerate(world["ranks"]):
        ours, ll, idx = res["recipe"][which]
        assert idx == shards[rank // n_model]
        assert ll == pytest.approx(ref_ll, rel=1e-4)
        _assert_params_close(ours, ref)


def test_data_axis_reduction_invariance(world):
    """(8, 1), (4, 2) and (2, 4) give the same step: the reduction over
    "data" and the gathers over "model" in model-rank order."""
    outs = world["ranks"][0]["layouts"]
    for params, lls in outs[1:]:
        _assert_params_close(params, outs[0][0], tol=1e-4, logw_tol=1e-4)
        assert lls[0] == pytest.approx(outs[0][1][0], rel=1e-5)


def test_em_improves_on_mesh(world):
    lls = world["ranks"][0]["em"][1]
    assert lls[1] > lls[0]
    assert lls[2] >= lls[1] - 1e-3


@pytest.mark.parametrize("env, want", [
    ({"JAX_COORDINATOR_ADDRESS": "h0:1234", "JAX_NUM_PROCESSES": "4",
      "SLURM_PROCID": "3"}, ("tcp://h0:1234", 4, 3)),
    ({"MASTER_ADDR": "h1", "MASTER_PORT": "29501", "WORLD_SIZE": "8",
      "RANK": "5"}, ("tcp://h1:29501", 8, 5)),
], ids=["jax-env", "torchrun-env"])
def test_initialize_wiring(monkeypatch, env, want):
    """`initialize` resolves the topology from the JAX package's
    variables (SLURM_PROCID for the process id), else torchrun's, and
    hands it to `init_process_group` (faked) with gloo on the CPU."""
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert distributed.initialize(device="cpu") is True
    addr, n, pid = want
    assert calls == [(("gloo",), {"init_method": addr, "world_size": n,
                                  "rank": pid})]


def test_initialize_single_process_noop(monkeypatch):
    """No coordinator and no process count: False, nothing initialized
    (and no device asked for, so no card is needed)."""
    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **k: called.append(1))
    assert distributed.initialize() is False
    assert not called


def test_global_mesh_spans_world(world):
    """`global_mesh(n_model=2)` over 8 ranks: a 4 x 2 ("data", "model")
    mesh, rank r at (r // 2, r % 2) as JAX's reshape lays it out."""
    for rank, res in enumerate(world["ranks"]):
        grid, names, d, m = res["mesh"]
        assert grid == np.arange(8).reshape(4, 2).tolist()
        assert tuple(names) == ("data", "model")
        assert (d, m) == (rank // 2, rank % 2)


def test_replicate_and_refusals(world):
    """`replicate` hands every rank rank 0's values; a mesh that does
    not cover the world, a model group whose ranks hold different
    utterances and a pool that does not split over "model" are
    refused."""
    for res in world["ranks"]:
        assert res["replicate"] == {"a": [0, 0, 0], "b": [0.5, 0.5]}
        mesh, group, pool = res["refusals"]
        assert "does not cover the 8 ranks" in mesh
        assert "a model group hold different utterances" in group
        assert "the Gaussian pool of 7 does not split into 2" in pool


def _fails_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise KeyError("planted")
    return dist.get_rank()


def test_cpu_world_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*planted"):
        distributed.cpu_world(2, _fails_on_rank_one, timeout=120)


def test_process_shard_matches_recipe_split(monkeypatch):
    from aaltoasr_tpu.formats.recipe import Recipe as JRecipe
    lines = [f"audio=/a/u{i}.wav" for i in range(10)]
    full = Recipe.read(lines)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: 1)
    shard = distributed.process_shard(full)
    want = [r.audio_path for r in JRecipe.read(lines, 2, 2)]
    assert [r.audio_path for r in shard] == want
    assert [r.audio_path for r in Recipe.read(lines, 2, 2)] == want
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    assert distributed.process_shard(full) is full


def test_dense_decode_sharded_over_batch(world):
    """The batch split over 8 ranks, one contiguous block each, against
    JAX's unsharded decode."""
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
    model, tree, fsa, cfg, pad, n = world["jdecode"]
    base = JDense(tree, fsa, model, cfg).decode_batch(pad, n, lattice=False)
    for res in world["ranks"]:
        assert len(res["decode"]) == len(base)
        for (words, lp), a in zip(res["decode"], base):
            assert words == a.words
            assert lp == pytest.approx(a.log_prob, rel=1e-5)


def test_device_trace_noop_without_dir(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("AALTOASR_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    assert capsys.readouterr().err == ""


def test_device_trace_writes_trace(monkeypatch, tmp_path, capsys):
    """With AALTOASR_TRACE_DIR set: one Chrome trace holding the traced
    operators, the span's ``asr/`` range and, as a process of their own
    on the trace's time base, the tracer's records; on stderr the JAX
    package's line, then the span and counter summary."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("AALTOASR_TRACE_DIR", str(trace_dir))
    before = profiling.counter("test.calls")
    with device_trace():
        with profiling.span("test.mm", 7):
            torch.ones(64, 64) @ torch.ones(64, 64)
        profiling.count("test.calls", 3)
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    (rng,) = [e for e in events if e.get("name") == "asr/test.mm"]
    (rec,) = [e for e in events if e.get("cat") == "asr"]
    assert rec["name"] == "test.mm" and rec["args"]["unit"] == 7
    assert rec["pid"] != rng["pid"]
    # the record lies inside its range, on the same time base
    assert rng["ts"] <= rec["ts"] + 1e-3
    assert rec["ts"] + rec["dur"] <= rng["ts"] + rng["dur"] + 1e-3
    assert profiling.counter("test.calls") == before + 3
    err = capsys.readouterr().err.splitlines()
    assert err[0] == f"device trace written to {trace_dir}"
    (line,) = [ln for ln in err if ln.split()[:2] == ["test.mm", "1"]]
    total_ms, self_ms = map(float, line.split()[2:])
    assert total_ms == self_ms >= 0
    assert err[-1] == "  counter test.calls 3"


def test_entry_matches_jax_entry():
    """`entry(device="cpu")`'s LNA log-probs against the JAX entry's on
    the same inputs: codes within one step and >= 99% identical, or,
    where the JAX package's own float32 codes are not that close to the
    exact ones (the entry's model is not placed on its features:
    features of +-18 against means of N(0, 2) and variances from 0.3),
    no further from the exact (float64) codes than the JAX package's,
    as `tests/test_torch_fullcov_codes.py` holds model CMLLR.  The
    exact codes come from the port's frontend in float64, so the port's
    float32 features are first held to the JAX entry's (rtol = atol =
    1e-4 on features to 18): a fault of the port's frontend cannot make
    it look closer to the exact codes."""
    import jax
    from __graft_entry__ import _MFCC_CFG, entry as j_entry
    from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
    jf, (js, jn) = j_entry()
    jout = np.asarray(jax.jit(jf)(js, jn))
    forward, (samples, n_frames) = t_entry.entry(device="cpu")
    np.testing.assert_array_equal(samples.numpy(), np.asarray(js))
    np.testing.assert_array_equal(n_frames.numpy(), np.asarray(jn))
    jfg = JGen(JConfig.parse(_MFCC_CFG))
    j_feature = jfg._compiled(samples.shape[1])
    jfeats = np.asarray(jax.jit(jax.vmap(
        lambda s, n: j_feature(s, n, jfg.params)))(js, jn))
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device="cpu")
    np.testing.assert_allclose(fg._run(samples, n_frames, jfeats.shape[1]),
                               jfeats, rtol=1e-4, atol=1e-4)
    out = forward(samples, n_frames)
    assert out.shape == jout.shape
    codes = quantize_lna_u16(out).numpy()
    jcodes = quantize_lna_u16(torch.as_tensor(np.array(jout))).numpy()
    assert np.abs(codes - jcodes).max() <= 1
    if (codes == jcodes).mean() >= 0.99:
        return
    feats = exact_features(MFCC_CFG, samples, n_frames)
    np.testing.assert_allclose(fg._run(samples, n_frames, feats.shape[1]),
                               feats, rtol=1e-4, atol=1e-4)
    exact = np.stack([exact_lna_codes(random_model(), f) for f in feats])
    assert (jcodes == exact).mean() < 0.99
    assert np.abs(codes - exact).max() <= 1
    assert (codes == exact).mean() >= (jcodes == exact).mean()


def test_dryrun_multichip_four(capsys):
    t_entry.dryrun_multichip(4)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    assert all(ln.startswith("dryrun phase ok: ") for ln in lines)
    assert "data x model = 2 x 2" in lines[0]


def test_new_modules_import_no_jax():
    """`parallel/`, `utils/profiling.py` and `__graft_entry_torch__.py`
    import (and the entry's forward runs) without jax in the process."""
    code = (
        "import sys\n"
        "import aaltoasr_tpu_torch.parallel\n"
        "import aaltoasr_tpu_torch.parallel.distributed\n"
        "import aaltoasr_tpu_torch.utils.profiling\n"
        "import __graft_entry_torch__ as e\n"
        "f, args = e.entry(device='cpu')\n"
        "f(*args)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'aaltoasr_tpu.')) or m == 'aaltoasr_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
