"""Driver entry points of the PyTorch port: the single-card forward step
and the multi-rank dry run.

Counterpart of `__graft_entry__.py`, which imports jax and stays the JAX
package's.  This file imports torch and `aaltoasr_tpu_torch`, never jax:

* `entry(device="cuda")` -> ``(forward, (samples, n_frames))``: batched
  audio -> MFCC features -> LNA-normalized GMM state log-probs, with the
  JAX entry's model, configuration and inputs;
* `dryrun_multichip(n)`: the JAX dry run's six phases (the data x model
  EM step, sharded dense and exact decodes, the wav -> LNA -> decode
  chain with and without CMLLR parameters, a time-split forward pass)
  over ``n`` gloo ranks on the CPU.
"""

import sys

import numpy as np
import torch

# the JAX dry run's serve-chain configuration: MFCC to 4 cepstra and a
# 4 x 4 feature transform whose parameters a speaker sets
_SERVE_CFG = """\
module
{
  name audio
  type audiofile
  sample_rate 16000
}
module
{
  name fft
  type fft
  sources audio
}
module
{
  name mel
  type mel
  sources fft
}
module
{
  name dct
  type dct
  sources mel
  dim 4
}
module
{
  name cmllr
  type lin_transform
  sources dct
  dim 4
}
"""


def entry(device="cuda"):
    """Forward step of the flagship pipeline: batched audio -> MFCC
    features -> GMM state log-probs (LNA-normalized), on ``device``.

    The model is the JAX entry's `_random_model` (G=512, S=128, D=39,
    K=8: the same numpy calls in the same order, `synth.random_model`)
    and the frontend is built unfused, as the JAX entry builds it, so
    neither CUDA kernel runs.  Returns ``(forward, (samples, n_frames))``
    at B=4 utterances of 16,000 samples on the device."""
    from aaltoasr_tpu_torch.device import resolve_device
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    from aaltoasr_tpu_torch.synth import MFCC_CFG, random_model

    dev = resolve_device(device)
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device=dev)
    scorer = GmmScorer.from_model(random_model(), device=dev)

    S_LEN = 16000
    B = 4
    T_pad = fg.num_frames(S_LEN)

    def forward(samples, n_frames):
        return scorer.lna_log_probs(fg._run(samples, n_frames, T_pad))

    rng = np.random.default_rng(0)
    samples = torch.as_tensor(
        rng.normal(0, 1000, (B, S_LEN)).astype(np.float32), device=dev)
    n_frames = torch.full((B,), T_pad, dtype=torch.int64, device=dev)
    return forward, (samples, n_frames)


def dryrun_multichip(n_devices: int) -> None:
    """The JAX dry run's six phases over ``n_devices`` ranks, each
    printing its ``dryrun phase ok:`` line: the full EM step on a
    (data x model) mesh at tiny shapes; the dense and the exact decode,
    and the wav -> LNA -> dense decode chain without and with CMLLR
    parameters, of a batch split over the ranks, each against rank 0's
    unsharded run (words identical, log-probs rel 1e-5); the forward
    pass with time split over the ranks against the unsharded
    `forward_assoc_chain` (total rel 1e-5).

    Runs on the CPU by design: ``n_devices`` spawned gloo processes
    (`parallel.distributed.cpu_world`), as the JAX dry run forces
    virtual CPU devices; one card cannot host several NCCL ranks.
    Raises when a rank fails."""
    from aaltoasr_tpu_torch.parallel.distributed import cpu_world
    for line in cpu_world(n_devices, _dryrun_rank, n_devices)[0]:
        print(line, flush=True)


def _decode_task():
    """The JAX dry run's 4-state model, 3-word lexicon and bigram LM."""
    from aaltoasr_tpu_torch.decoder.lexicon import (
        build_prefix_tree, read_lexicon)
    from aaltoasr_tpu_torch.decoder.ngram import NGramFsa
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.arpa import ArpaLM

    D = 4
    dmodel = model_io.HmmModel(
        dim=D, cov_type="diagonal_cov",
        means=np.eye(4, D) * 5.0, covars=np.ones((4, D)),
        mixtures=[(np.array([i], np.int32), np.array([1.0]))
                  for i in range(4)],
        phones=[model_io.HmmPhone("a", [0]), model_io.HmmPhone("b", [1]),
                model_io.HmmPhone("c", [2]), model_io.HmmPhone("_", [3])],
        transitions={i: [(0, 0.5), (1, 0.5)] for i in range(4)})
    lex = read_lexicon("yksi a b\nkaksi b a\nkolme c a\n_ _\n")
    tree = build_prefix_tree(dmodel, lex)
    vocab = ["</s>", "<s>", "kaksi", "kolme", "yksi"]
    wi = {w: i for i, w in enumerate(vocab)}
    uni = {(wi[w],): (-0.7, -0.3) for w in vocab}
    bi = {(wi["<s>"], wi["yksi"]): (-0.3, 0.0),
          (wi["yksi"], wi["kaksi"]): (-0.3, 0.0)}
    fsa = NGramFsa.from_arpa(ArpaLM(order=2, vocab=vocab, word_index=wi,
                                    ngrams=[{}, uni, bi]))
    return dmodel, tree, fsa


def _split_decode(label, decode, obs, n_frames, rank, n):
    """``decode`` on this rank's block of the batch; rank 0 holds every
    rank's words and log-probs against its unsharded decode."""
    import torch.distributed as dist
    b = obs.shape[0] // n
    block = slice(rank * b, (rank + 1) * b)
    mine = [(r.words, r.log_prob)
            for r in decode(obs[block], n_frames[block])]
    got = [None] * n
    dist.all_gather_object(got, mine)
    if rank == 0:
        base = [(r.words, r.log_prob) for r in decode(obs, n_frames)]
        got = [x for part in got for x in part]
        for i, ((w, lp), (bw, blp)) in enumerate(zip(got, base)):
            if w != bw or abs(lp - blp) > 1e-5 * abs(blp):
                raise RuntimeError(
                    f"{label}: utterance {i} split {w} {lp}, unsharded "
                    f"{bw} {blp}")


def _log_matmul(b, a):
    from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
    return logsumexp(b[:, :, None] + a[None, :, :], dim=1)


def _dryrun_rank(n_devices: int) -> list:
    """One rank of `dryrun_multichip`: runs the six phases and returns
    their lines."""
    import torch.distributed as dist
    from aaltoasr_tpu_torch.decoder.search import BeamSearch, SearchConfig
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
    from aaltoasr_tpu_torch.formats.feaconf import (
        FeatureConfig, ModuleConfig)
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu_torch.ops import chain as chain_ops
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO, logsumexp
    from aaltoasr_tpu_torch.parallel.mesh import (
        make_mesh, sharded_train_step)
    from aaltoasr_tpu_torch.synth import random_model

    rank = dist.get_rank()
    lines = []
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model

    # (1) the EM step on a data x model mesh, at the JAX dry run's shapes
    model = random_model(G=64, S=16, D=8, K=4)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device="cpu")
    B, T = n_data * 2, 16
    rng = np.random.default_rng(1)
    g = pad_chain(build_chain(model, table, ["p0", "p1", "p2"]), 8, fan=4)
    graphs = {k: np.stack([np.asarray(v)] * B) for k, v in g.items()}
    feats = rng.normal(0, 2, (B, T, model.dim)).astype(np.float32)
    n_frames = np.full((B,), T, dtype=np.int64)
    step_g = n_model * 8
    G = -(-model.num_gaussians // step_g) * step_g
    means = np.zeros((G, model.dim), dtype=np.float32)
    covars = np.ones((G, model.dim), dtype=np.float32)
    means[:model.num_gaussians] = model.means
    covars[:model.num_gaussians] = model.covars
    params = {"means": means, "covars": covars,
              "comp_idx": scorer.comp_idx.numpy(),
              "comp_logw": scorer.comp_logw.numpy()}
    mesh = make_mesh(n_data=n_data, n_model=n_model, device="cpu")
    step = sharded_train_step(mesh, table.num_slots)
    mine = slice(2 * mesh.get_local_rank("data"),
                 2 * mesh.get_local_rank("data") + 2)
    new_params, ll = step(params, feats[mine],
                          {k: v[mine] for k, v in graphs.items()},
                          n_frames[mine])
    lls = [None] * n_devices
    dist.all_gather_object(lls, float(ll))
    if not (np.all(np.isfinite(lls)) and len(set(lls)) == 1
            and torch.isfinite(new_params["means"]).all()):
        raise RuntimeError(f"EM step: log-likelihoods {lls} over the ranks")
    lines.append(f"dryrun phase ok: train (EM step, data x model = "
                 f"{n_data} x {n_model})")

    # (2) the dense and (3) the exact decode, the batch split over ranks
    dmodel, tree, fsa = _decode_task()
    cfg = SearchConfig(num_tokens=64, num_records=8, beam=1e9,
                       lm_scale=1.0, duration_scale=0.0)
    dense = DenseBeamSearch(tree, fsa, dmodel, cfg, device="cpu")
    Bd, Td = n_devices * 2, 12
    rngd = np.random.default_rng(3)
    obs = torch.as_tensor(rngd.normal(
        -5.0, 2.0, (Bd, Td, dmodel.num_states)).astype(np.float32))
    nd = np.full(Bd, Td, np.int64)

    def dense_decode(o, n):
        return dense.decode_batch(o, n, lattice=False)

    _split_decode("dense decode", dense_decode, obs, nd, rank, n_devices)
    lines.append(f"dryrun phase ok: serve dense decode (batch {Bd} sharded "
                 f"over {n_devices} devices)")
    exact = BeamSearch(tree, fsa, dmodel, SearchConfig(
        num_tokens=32, num_records=8, beam=1e9, lm_scale=1.0,
        duration_scale=0.0), device="cpu")
    _split_decode("exact decode",
                  lambda o, n: exact.decode_batch(o, n, lattice=False),
                  obs, nd, rank, n_devices)
    lines.append(f"dryrun phase ok: serve exact decode (batch {Bd} sharded "
                 f"over {n_devices} devices)")

    # (4) raw audio -> MFCC -> LNA log-probs -> dense decode, and (5) the
    # same with a speaker's CMLLR transform set as lin_transform
    # parameters (the .spkc path)
    fg = FeatureGenerator(FeatureConfig.parse(_SERVE_CFG), device="cpu")
    scorer_d = GmmScorer.from_model(dmodel, device="cpu")
    S_LEN = 2048
    Tn = fg.num_frames(S_LEN)
    samples = torch.as_tensor(
        rngd.normal(0, 1000, (Bd, S_LEN)).astype(np.float32))
    nfr = torch.full((Bd,), Tn, dtype=torch.int64)

    def serve_decode(s, n):
        lna = scorer_d.lna_log_probs(fg._run(s, torch.as_tensor(n), Tn))
        return dense.decode_batch(lna, n, lattice=False)

    _split_decode("serve chain", serve_decode, samples, nfr, rank,
                  n_devices)
    lines.append(f"dryrun phase ok: serve chain wav->LNA->decode (batch "
                 f"{Bd} sharded over {n_devices} devices)")
    adapt = ModuleConfig()
    adapt.set("matrix", [float(x) for x in (np.eye(4) * 0.9).reshape(-1)])
    adapt.set("bias", [0.1, 0.0, -0.1, 0.0])
    fg.set_parameters("cmllr", adapt)
    _split_decode("adapted serve chain", serve_decode, samples, nfr, rank,
                  n_devices)
    lines.append(f"dryrun phase ok: adaptation-applied decode (CMLLR "
                 f"params, batch {Bd} sharded over {n_devices} devices)")

    # (6) the forward pass with time split over the ranks: each rank forms
    # the log-semiring product of its frames' step matrices
    # A_t[i, j] = trans[j -> i] + obs_t[i] (rank 0's first factor carries
    # alpha_0 in column 0), the products are all-gathered, and each rank
    # enters its frames with the product of the earlier ranks' factors
    trans = chain_ops.dense_transition_matrix(g)
    P = g["pdf"].shape[0]
    T2 = n_devices * 4
    obs_pos = torch.as_tensor(rngd.normal(
        -2.0, 1.0, (T2, P)).astype(np.float32))
    alphas_ref, total_ref = chain_ops.forward_assoc_chain(
        obs_pos, g, trans_dense=trans)
    c = T2 // n_devices
    mine = obs_pos[rank * c:(rank + 1) * c]
    prod = torch.full((P, P), LOG_ZERO)
    prod.fill_diagonal_(0.0)
    steps = []
    for t in range(mine.shape[0]):
        if rank == 0 and t == 0:
            a = torch.full((P, P), LOG_ZERO)
            a[0, 0] = 0.0
            a[:, 0] = torch.clamp(a[:, 0] + mine[0], min=LOG_ZERO)
        else:
            a = trans + mine[t][:, None]
        steps.append(a)
        prod = torch.clamp(_log_matmul(a, prod), min=LOG_ZERO)
    parts = [torch.empty_like(prod) for _ in range(n_devices)]
    dist.all_gather(parts, prod)
    enter = torch.full((P, P), LOG_ZERO)
    enter.fill_diagonal_(0.0)
    for part in parts[:rank]:
        enter = torch.clamp(_log_matmul(part, enter), min=LOG_ZERO)
    alpha = enter[:, 0]
    alphas = []
    for a in steps:
        alpha = torch.clamp(logsumexp(a + alpha[None, :], dim=1),
                            min=LOG_ZERO)
        alphas.append(alpha)
    whole = enter
    for part in parts[rank:]:
        whole = torch.clamp(_log_matmul(part, whole), min=LOG_ZERO)
    nump = int(g["num_positions"])
    beta = torch.full((P,), LOG_ZERO)
    beta[nump - 1] = float(g["final_logp"])
    total = float(logsumexp(whole[:, 0] + beta, dim=0))
    ref = alphas_ref[rank * c:(rank + 1) * c]
    if (abs(total - float(total_ref)) > 1e-5 * abs(float(total_ref))
            or not torch.allclose(torch.stack(alphas), ref, rtol=1e-5,
                                  atol=1e-3)):
        raise RuntimeError(f"time-split forward: total {total}, unsharded "
                           f"{float(total_ref)}")
    lines.append(f"dryrun phase ok: assoc-scan forward (T={T2} sharded over "
                 f"{n_devices} devices)")
    if "jax" in sys.modules:
        raise RuntimeError("a dry-run rank loaded jax")
    return lines
