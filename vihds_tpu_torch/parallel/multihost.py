"""Multi-process start-up: one process per rank, a ``torch.distributed``
process group, one device per rank.

The port of ``vihds_tpu/parallel/multihost.py``.  ``run_xval`` and
``call_run_xval`` call ``initialize_from_args`` first (``--distributed
HOST:PORT,NPROC,PID`` on each rank, or ``--distributed auto`` under
``torchrun``), build the mesh over the ranks with the ordinary ``--mesh``
flags, and ``Training`` writes artifacts and TensorBoard files on
``is_main()`` only.  Every rank loads the same data and runs the same host
loop in lockstep.

The backend follows the device: NCCL where every rank of a host has a card
of its own (``cuda:<local rank>``), gloo on the CPU and where ranks share
cards (NCCL refuses two ranks on one device).  A process group that fails
to start raises; nothing carries on unsharded.
"""

import datetime
import os

import torch
import torch.distributed as dist

from vihds_tpu_torch import parallel

#: torchrun's variables that ``--distributed auto`` reads
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

#: seconds a collective waits for the other ranks (``$VIHDS_DIST_TIMEOUT``)
DEFAULT_TIMEOUT = 1800


def rank_device(device, world, rank):
    """(this rank's device, the backend) for ranks on ``device``'s type: on
    CUDA, ``cuda:<local rank>`` under NCCL where the host's ranks
    (``$LOCAL_WORLD_SIZE``, else all ``world``) have a card each, else the
    cards shared round-robin under gloo; the CPU under gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % cards), "gloo"


def initialize(init_method=None, num_processes=None, process_id=None, device="cpu",
               timeout=None):
    """Start the process group (nothing where single-process: no
    ``init_method`` and at most one process).  Returns (process count, this
    process's rank, its device)."""
    if init_method is None and (num_processes or 1) <= 1:
        return 1, 0, torch.device(device)
    dev, backend = rank_device(device, num_processes, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    seconds = timeout or int(os.environ.get("VIHDS_DIST_TIMEOUT", DEFAULT_TIMEOUT))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=seconds))
    n, i = dist.get_world_size(), dist.get_rank()
    print("torch.distributed: process %d of %d (backend %s, device %s)" % (i, n, backend, dev),
          flush=True)
    return n, i, dev


def initialize_from_args(args, device="cpu"):
    """Product entry: wire ``--distributed`` (or ``$VIHDS_DISTRIBUTED``) into
    the process group.

    * ``HOST:PORT,NPROC,PID``: rank PID of NPROC, meeting at
      ``tcp://HOST:PORT``, NPROC ranks on this host;
    * ``auto``: ``env://`` under ``torchrun`` (its ``MASTER_ADDR``,
      ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``LOCAL_WORLD_SIZE``), the counterpart of the TPU pod's discovery;
    * ``None`` / empty: single-process.

    Call it before any other device use.  Returns (process count, rank,
    this rank's device)."""
    spec = getattr(args, "distributed", None) or os.environ.get("VIHDS_DISTRIBUTED")
    if not spec:
        return 1, 0, torch.device(device)
    if spec == "auto":
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise SystemExit("--distributed auto needs torchrun's environment; %s not set"
                             % ", ".join(missing))
        return initialize("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                          device=device)
    try:
        addr, nproc, pid = spec.rsplit(",", 2)
        nproc, pid = int(nproc), int(pid)
    except ValueError:
        raise SystemExit(
            "--distributed expects 'auto' or 'HOST:PORT,NPROC,PID'; got %r" % spec
        )
    return initialize("tcp://" + addr, nproc, pid, device=device)


def shutdown():
    """End the process group, where one was started, and the meshes over it."""
    if dist.is_initialized():
        parallel.forget_meshes()
        dist.destroy_process_group()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_main():
    """True on the process that owns artifact and TensorBoard writes."""
    return process_index() == 0


def barrier():
    """Wait for every rank (nothing where single-process)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_string(s, max_len=4096):
    """Replicate rank 0's string to every rank, through a fixed-size uint8
    buffer over the process group.  Shares rank 0's results / checkpoint
    directory with the trainer-less ranks of a ``--distributed`` launch."""
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if s:
        raw = s.encode("utf-8")
        if len(raw) > max_len:
            raise ValueError("broadcast_string: %d bytes > max_len %d" % (len(raw), max_len))
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    if dist.is_initialized():
        on = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        out = buf.to(on)
        dist.broadcast(out, src=0)
        buf = out.cpu()
    return bytes(buf.numpy()).rstrip(b"\x00").decode("utf-8")


def is_multiprocess_mesh(mesh):
    """True when ``mesh`` spans more than this process."""
    return mesh is not None and mesh.size > 1


def global_mesh(n_data=None, n_sample=None, device="cpu"):
    """A mesh over every rank of the process group."""
    return parallel.make_mesh(n_data=n_data, n_sample=n_sample, device=device)


def host_local_batch_to_global(mesh, batch):
    """This rank's shard of a batch that every rank holds whole: the rows of
    its data index of the batch-indexed leaves (padded with row 0), the time
    vector as it is.  (The JAX package assembles a global array from each
    process's rows; here every rank runs the decoder block on its own.)"""
    return mesh.batch_rows(batch)
