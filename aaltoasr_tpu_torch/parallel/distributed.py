"""Multi-process entry: `torch.distributed` initialization + global meshes.

Counterpart of `aaltoasr_tpu/parallel/distributed.py`.  The reference
scales over hosts with scheduler job arrays and a shared filesystem
(`submit-to-slurm.sh`, `ClusterManager.pm:42-115`, `combine_stats`
epilogs).  Here every rank runs the same script, one rank per GPU, calls
:func:`initialize` once and builds its mesh over the whole process group
(:func:`global_mesh`); the `all_reduce` inside `sharded_train_step`
rides NVLink/InfiniBand through NCCL instead of .gks files.

Launch recipe (one rank per GPU)::

    # one host, 4 GPUs: torchrun supplies MASTER_ADDR/PORT, WORLD_SIZE,
    # RANK and LOCAL_RANK
    torchrun --nproc-per-node 4 train.py ...

    # SLURM: one task per GPU; the JAX package's variables work too
    srun --ntasks 8 --gpus-per-task 1 env \\
      JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=8 \\
      python train.py ...              # process id from $SLURM_PROCID

and in ``train.py`` each rank steps on its own utterances::

    initialize()
    mesh = global_mesh(n_model=2)
    mine = process_shard(recipe, mesh=mesh)   # its data coordinate's
    # ... the features, stacked graphs and frame counts of ``mine`` ...
    step = sharded_train_step(mesh, num_trans_slots)
    params, ll = step(replicate(params, mesh), features, graph, n_frames)

The JAX package's TPU-pod branch (a runtime that self-describes through
``TPU_WORKER_HOSTNAMES``) has no counterpart: a GPU cluster always names
its coordinator.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from aaltoasr_tpu_torch.device import resolve_device


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: torch.device | str = "cuda") -> bool:
    """Initialize the default process group for a multi-process run.

    Arguments default from the environment: JAX_COORDINATOR_ADDRESS
    (``host:port``), JAX_NUM_PROCESSES, JAX_PROCESS_ID or SLURM_PROCID,
    as the JAX package reads them; failing those, torchrun's
    MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK.  NCCL on CUDA (each
    rank takes the card LOCAL_RANK names, else rank % cards), gloo when
    ``device`` is the CPU.  Returns True when the group was initialized,
    False for a single-process run (no coordinator and no process
    count configured), which initializes nothing."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "SLURM_PROCID", "RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None:
        raise ValueError("a multi-process run needs both the coordinator "
                         "address and the number of processes")
    dev = resolve_device(device)
    process_id = process_id or 0
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(
            local if local is not None
            else process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def global_mesh(n_model: int = 1, device: torch.device | str = "cuda"):
    """("data", "model") mesh over EVERY rank of the process group.

    Call after :func:`initialize`; with P ranks the data axis spans
    P // n_model entries, so recipes sharded with
    ``process_shard(recipe, mesh=mesh)`` feed disjoint utterances into
    one reduction."""
    from aaltoasr_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_model=n_model, device=device)


def process_shard(recipe, num_batches: int = 0, mesh=None):
    """Split a recipe across processes like the reference's -B/-I
    (`aku/Recipe.hh:97-112`): rank i (0-based) of N takes the 1-based
    batch i+1.  With ``mesh``, over its data axis instead: the ranks of
    data coordinate i take batch i+1 of the axis' size, as
    `sharded_train_step` wants them.  Without a process group: world
    size 1, rank 0."""
    if mesh is not None:
        world = mesh.size(mesh.mesh_dim_names.index("data"))
        rank = mesh.get_local_rank("data")
    elif dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    return recipe.shard(num_batches or world, rank + 1)


def cpu_world(n: int, fn, *args, timeout: float = 600.0) -> list:
    """``fn(*args)`` in ``n`` spawned CPU processes of one thread each,
    joined in one gloo process group (rendezvous through a FileStore in
    a fresh temporary directory): the counterpart of the JAX package's
    virtual CPU devices, for dry runs and tests of multi-rank programs
    on a host with one card or none.  ``fn`` must be importable by name
    (the children re-import its module).  Returns the ranks' results in
    rank order; raises when a rank fails or ``timeout`` seconds pass."""
    ctx = multiprocessing.get_context("spawn")
    results, failed = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_world_rank, daemon=True, args=(
            os.path.join(tmp, "store"), r, n, fn, args, q))
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n and failed is None:
                rank, ok, value = q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
                if ok:
                    results[rank] = value
                else:
                    failed = f"rank {rank} of {n} failed:\n{value}"
        except queue.Empty:
            failed = (f"the {n}-rank CPU world did not finish in "
                      f"{timeout:g} s (ranks done: {sorted(results)})")
        finally:
            for p in procs:
                p.join(timeout=0.1 if failed else 60)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failed:
        raise RuntimeError(failed)
    return [results[r] for r in range(n)]


def _world_rank(store, rank, n, fn, args, q):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, n),
                                rank=rank, world_size=n)
        try:
            q.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        q.put((rank, False, traceback.format_exc()))
