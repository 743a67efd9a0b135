"""Data x model parallelism over a `torch.distributed` device mesh.

Counterpart of `aaltoasr_tpu/parallel/mesh.py`.  The reference's only
parallelism is utterance sharding over a batch cluster with file-based
reduce (`aku/Recipe.hh:97-112` shard split, `combine_stats` + scheduler
epilogs, `train.pl:373-392`); here it is one program run by every rank
of a process group, one rank per device:

* **data axis**: each rank holds its own block of the batch's
  utterances; sufficient statistics are `all_reduce`-summed across the
  axis, the in-NVLink analog of the .gks/.mcs dumps + combine_stats.
* **model axis**: each rank scores a contiguous block of the Gaussian
  pool; the per-Gaussian log-likelihoods are all-gathered (mixtures mix
  arbitrary pool members), the M-step updates the rank's own rows, and
  the updated parameters are all-gathered back.

Where JAX's `shard_map` splits global arrays, here each rank holds its
own part, as a multi-process JAX run builds a global array from every
process's local data: the model is the same on every rank (see
:func:`replicate`), the utterances are the rank's data block (the ranks
of one model group, which share a data coordinate, pass the same ones;
`distributed.process_shard(recipe, mesh=mesh)` gives them that), and
every rank returns the same global outputs.  The mesh is laid out
row-major as JAX's reshape is: rank r sits at data coordinate
r // n_model and model coordinate r % n_model.  NCCL serves CUDA meshes
(one rank per card: NCCL refuses two ranks on one device), gloo CPU
meshes.  Products run in IEEE float32, as the reference's
`Precision.HIGHEST` dots.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aaltoasr_tpu_torch.device import ieee_float32, resolve_device
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO, logsumexp
from aaltoasr_tpu_torch.train import estep

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: torch.device | str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the process group's ranks.

    Without a process group it starts a one-process group on a store of
    its own (NCCL for a CUDA device, gloo for the CPU), so a single
    process needs no launcher.  ``n_data`` defaults to world size //
    ``n_model``; the mesh must cover the world."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(_BACKEND[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover the "
                         f"{world} ranks of the process group")
    return DeviceMesh(dev.type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate(tree: dict, mesh: DeviceMesh) -> dict:
    """A dict of tensors (or arrays) on the mesh's device, every rank
    holding rank 0's values (broadcast over the whole world)."""
    dev = _mesh_device(mesh)
    out = {}
    for k, v in tree.items():
        t = torch.as_tensor(v).to(dev).contiguous()
        dist.broadcast(t, src=0)
        out[k] = t
    return out


def _gather(t: torch.Tensor, mesh: DeviceMesh, dim: int) -> torch.Tensor:
    """``t`` from every rank of the model axis, concatenated along
    ``dim`` in model-rank order."""
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group("model"))
    return torch.cat(parts, dim=dim)


def _scorer_tables(means, covars):
    """Scoring tables from means/covars on the device: A [G, 2D] over
    [x^2, x] and the bias [G] (GmmScorer.from_model /
    DiagonalGaussian::set_constant, `aku/Distributions.cc:1273-1287`:
    C = log sqrt(prod(precision)))."""
    prec = torch.where(covars > 0, 1.0 / covars, torch.zeros_like(covars))
    A = torch.cat([-0.5 * prec, means * prec], dim=1)
    const = 0.5 * torch.log(torch.clamp(prec, min=1e-30)).sum(1)
    bias = const - 0.5 * (means * means * prec).sum(1)
    return A, bias


def _estep_local(mesh, means, covars, comp_idx, comp_logw, x, graph,
                 n_frames, num_trans_slots):
    """The E-step of this rank's utterances against its pool block:
    statistics summed over the utterances, one flat buffer (gamma [G],
    mean_acc [G, D], sec_acc [G, D], mix_gamma [Sp, K], trans_acc [NT],
    ll [1]) and the split sizes."""
    A_local, bias_local = _scorer_tables(means, covars)     # [Gl, 2D], [Gl]
    Bl, T, D = x.shape
    xx = torch.cat([x * x, x], dim=-1)                      # [Bl, T, 2D]
    gll = _gather(xx @ A_local.T + bias_local, mesh, dim=2)  # [Bl, T, G]
    G = gll.shape[2]
    pdf = graph["pdf"]                                      # [Bl, P]
    P = pdf.shape[1]
    Sp, K = comp_idx.shape
    cidx = comp_idx[pdf]                                    # [Bl, P, K]
    clogw = comp_logw[pdf]
    gll_pk = estep._take_t(gll, cidx)                       # [Bl, T, P, K]
    obs_pos = logsumexp(gll_pk + clogw[:, None], dim=-1)    # [Bl, T, P]
    gamma, trans_post, total = estep.masked_forward_backward(
        obs_pos, graph, n_frames, num_trans_slots)

    log_resp = clogw[:, None] + gll_pk - obs_pos[..., None]
    R = gamma[..., None] * torch.exp(torch.clamp(log_resp, min=-80.0))
    R_flat = R.reshape(Bl, T, P * K)
    del gll, gll_pk, log_resp, R
    g_flat = cidx.reshape(-1)
    c = R_flat.sum(1)                                       # [Bl, P*K]
    RT = R_flat.transpose(1, 2)                             # [Bl, P*K, T]
    zeros = x.new_zeros
    gamma_g = zeros(G).index_add_(0, g_flat, c.reshape(-1))
    m1 = zeros(G, D).index_add_(0, g_flat, torch.bmm(RT, x).reshape(-1, D))
    m2 = zeros(G, D).index_add_(
        0, g_flat, torch.bmm(RT, x * x).reshape(-1, D))
    mix_gamma = zeros(Sp, K).index_add_(0, pdf.reshape(-1),
                                        c.reshape(Bl * P, K))
    parts = [gamma_g, m1, m2, mix_gamma, trans_post.sum(0),
             total.sum().reshape(1)]
    return (torch.cat([p.reshape(-1) for p in parts]),
            [p.numel() for p in parts])


def _block(x, n: int, i: int, what: str):
    """Block ``i`` of ``n`` contiguous blocks along dim 0 (P("model")
    splits)."""
    if x.shape[0] % n:
        raise ValueError(f"{what} of {x.shape[0]} does not split into "
                         f"{n} equal blocks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _same_in_group(x, n_frames, mesh) -> None:
    """Refuse a step whose model group's ranks hold different
    utterances: their log-likelihood blocks would be gathered as one
    batch's.  Compares the shape and position-weighted sums of the
    features' bits and of the frame counts (exact integer sums) over
    the "model" group; one host sync."""
    B = x.shape[0]
    bits = x.contiguous().view(torch.int32).reshape(B, -1).sum(
        1, dtype=torch.int64)
    w = torch.arange(1, B + 1, device=x.device)
    sig = torch.stack([torch.tensor(B, device=x.device),
                       torch.tensor(x.numel(), device=x.device),
                       (w * bits).sum(), (w * n_frames).sum()])
    neg = -sig
    group = mesh.get_group("model")
    dist.all_reduce(sig, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(neg, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(sig, -neg):
        raise ValueError("the ranks of a model group hold different "
                         "utterances: each must pass its data block "
                         "(distributed.process_shard(recipe, mesh=mesh))")


def sharded_estep(mesh: DeviceMesh, num_trans_slots: int):
    """The E-step of :func:`sharded_train_step` alone:
    ``estep(params, features, graph, n_frames) -> stats``, the
    statistics summed over every rank's utterances (gamma [G], mean_acc
    and sec_acc [G, D], mix_gamma [Sp, K], trans_acc [NT], ll []), the
    same on every rank.  Arguments as the step's."""
    dev = _mesh_device(mesh)
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    m = mesh.get_local_rank("model")

    def on_dev(v):
        t = torch.as_tensor(v).to(dev)
        return t.float() if t.is_floating_point() else t.long()

    def estep(params, features, graph, n_frames):
        means_l, covars_l = (
            on_dev(_block(params[k], n_model, m, "the Gaussian pool"))
            for k in ("means", "covars"))
        comp_idx = on_dev(params["comp_idx"])
        x, n = on_dev(features), on_dev(n_frames)
        if n_model > 1:
            _same_in_group(x, n, mesh)
        with ieee_float32():
            flat, sizes = _estep_local(
                mesh, means_l, covars_l, comp_idx,
                on_dev(params["comp_logw"]), x,
                {k: on_dev(v) for k, v in graph.items()}, n,
                num_trans_slots)
        # reduce the data blocks (the combine_stats analog)
        dist.all_reduce(flat, group=mesh.get_group("data"))
        gamma, m1, m2, mg, trans, ll = torch.split(flat, sizes)
        G = gamma.shape[0]
        return {"gamma": gamma, "mean_acc": m1.view(G, -1),
                "sec_acc": m2.view(G, -1),
                "mix_gamma": mg.view(comp_idx.shape), "trans_acc": trans,
                "ll": ll[0]}

    return estep


def sharded_train_step(mesh: DeviceMesh, num_trans_slots: int,
                       minvar: float = 0.1):
    """The EM step (E-step FB + ML M-step) over the mesh:
    ``step(params, features, graph, n_frames) -> (params', ll)``.

    params: means/covars [G, D] and comp_idx/comp_logw [Sp, K], the same
    on every rank; G must split over "model".  features [B, T, D], graph
    the stacked chain tables [B, ...] and n_frames [B]: this rank's
    utterances (tensors or arrays; B and T may differ between data
    coordinates).  The ranks of a model group pass the same utterances,
    else the step raises.  Returns the updated global params on every
    rank and the total log-likelihood of every rank's utterances (a
    0-dim tensor on the mesh's device)."""
    dev = _mesh_device(mesh)
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    m = mesh.get_local_rank("model")
    estep = sharded_estep(mesh, num_trans_slots)

    def step(params, features, graph, n_frames):
        st = estep(params, features, graph, n_frames)
        means_l, covars_l = (
            torch.as_tensor(_block(params[k], n_model, m,
                                   "the Gaussian pool")).to(dev).float()
            for k in ("means", "covars"))
        comp_logw = torch.as_tensor(params["comp_logw"]).to(dev).float()
        Gl = means_l.shape[0]
        rows = slice(m * Gl, (m + 1) * Gl)
        gamma = st["gamma"][rows]
        has_data = gamma > 0
        safe = torch.where(has_data, gamma, torch.ones_like(gamma))
        new_mean = st["mean_acc"][rows] / safe[:, None]
        new_cov = torch.clamp(st["sec_acc"][rows] / safe[:, None]
                              - new_mean ** 2, min=minvar)
        means_l = torch.where(has_data[:, None], new_mean, means_l)
        covars_l = torch.where(has_data[:, None], new_cov, covars_l)
        # mixture weight ML update (Distributions.cc:2277-2283)
        mg = st["mix_gamma"]
        tot = mg.sum(1, keepdim=True)
        w = torch.where(tot > 0, mg / torch.clamp(tot, min=1e-30),
                        torch.exp(comp_logw))
        new_logw = torch.log(torch.clamp(w, min=1e-30))
        new_logw = torch.where(comp_logw <= LOG_ZERO / 2,
                               torch.full_like(new_logw, LOG_ZERO), new_logw)
        new_params = {"means": _gather(means_l, mesh, dim=0),
                      "covars": _gather(covars_l, mesh, dim=0),
                      "comp_idx": torch.as_tensor(params["comp_idx"]).to(
                          dev).long(),
                      "comp_logw": new_logw}
        return new_params, st["ll"]

    return step
