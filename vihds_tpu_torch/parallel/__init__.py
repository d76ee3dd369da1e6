"""Training over several processes: a (data, sample) mesh over the ranks of
a ``torch.distributed`` process group.

The port of ``vihds_tpu/parallel``.  The JAX package runs one jitted
program over a ``Mesh(('data', 'sample'))`` of devices and lets GSPMD place
the collectives.  Here each rank is one process with one device, and the
mesh shards the decoder block, the costly part of a step, by hand
(``shard_block``):

* every rank runs the encoder, the draws (the whole ``u[B, K, n_theta]``
  from the same generator), the clip and the device conditioning on the
  whole batch, and hands the block the conditioned draws;
* the block (integration, observation, the observations' log-likelihood)
  runs on this rank's rows ``[d * Bd, (d + 1) * Bd)`` of the batch (over
  'data', ``Bd = ceil(B / D)``) and its samples ``[s * Ks, (s + 1) * Ks)``
  (over 'sample', ``Ks = ceil(K / S)``, ``constrain_u``): every
  ``[B, K, ...]`` intermediate of the block, the ODE trajectory included,
  is sharded over both axes; rows and samples past B and K are padding
  (copies of row or sample 0) that no result reads;
* the blocks' log-likelihoods are gathered to every rank, which then forms
  the IWAE bound of the whole batch (the logsumexp over K, the masked mean
  over rows) exactly as one process does;
* in the backward every rank pulls the bound's cotangent of its own block
  (the gather's backward takes the block's slice, so no cotangent is
  counted twice), and one gather of the blocks' cotangents of the draws
  gives every rank the whole cotangent; the decoder params the block reads
  sum their blocks' gradients over the ranks in one flat buffer, in rank
  order.  The rest of the backward, its sums over K and over rows
  included, runs whole on every rank in the order one process runs it.

So the ranks hold the same params and optimizer state step after step, and
a step of the fused kernels' route equals the one-process step bit for bit
where the block's kernels and operations are row-independent (as the
``dr`` kernels are).  A training step takes two collectives: the forward's
gather and the backward's.  Evaluation (``training.sharded_eval_step``)
shards the same block, and sums each row's importance-weighted moments over
the sample ranks and gathers the rows over the data ranks.

Gloo cannot gather CUDA tensors; under gloo (the CPU, and ranks that share
one card) a collective goes through host memory.  ``STATS`` counts the
collectives of this process and the host seconds spent in them.
"""

import contextlib
import time

import torch
import torch.distributed as dist

_ACTIVE_MESH = None

#: the collectives of this process: their count and the host seconds spent
#: in them (host staging included, the wait for the device before it not)
STATS = {"collectives": 0, "seconds": 0.0}


def active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh that ``training`` shards over."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def shard_span(n, parts, index):
    """The padded span of shard ``index`` of ``n`` items over ``parts``:
    (first item, items a shard).  Items at or past ``n`` are padding."""
    per = -(-n // parts)
    return index * per, per


def _span_index(n, parts, index, device):
    """The indices of shard ``index``, padding as index 0, and which are real."""
    lo, per = shard_span(n, parts, index)
    idx = torch.arange(lo, lo + per, device=device)
    real = idx < n
    return torch.where(real, idx, torch.zeros_like(idx)), real


class Mesh:
    """A (data, sample) mesh over the ranks of the default process group:
    rank r sits at (r // n_sample, r % n_sample), as the JAX package lays
    devices out (``np.array(devices).reshape(n_data, n_sample)``).
    ``data_group`` joins the ranks of this rank's sample index (one per data
    shard), ``sample_group`` those of its data index (one per sample shard);
    None where the group is this rank alone."""

    def __init__(self, n_data, n_sample, rank=0, device="cpu"):
        self.shape = {"data": n_data, "sample": n_sample}
        self.size = n_data * n_sample
        self.rank = rank
        self.data_index, self.sample_index = divmod(rank, n_sample)
        self.device = torch.device(device)
        self.data_group = self.sample_group = self.world_group = None
        if self.size > 1:
            # every rank creates every group, in one order
            for s in range(n_sample):
                group = dist.new_group([d * n_sample + s for d in range(n_data)])
                if s == self.sample_index and n_data > 1:
                    self.data_group = group
            for d in range(n_data):
                group = dist.new_group([d * n_sample + s for s in range(n_sample)])
                if d == self.data_index and n_sample > 1:
                    self.sample_group = group
            self.world_group = dist.group.WORLD
        self.gloo = self.size > 1 and dist.get_backend() == "gloo"

    # ---------------------------------------------------------- the blocks
    def rows(self, x, n):
        """This rank's rows of ``x``'s first ``n`` (dim 0), padded with row 0."""
        return x.index_select(0, batch_shardings(self, n, x.device))

    def batch_rows(self, batch):
        """A batch (dict) with each row tensor cut to this rank's rows;
        ``times`` stays whole."""
        n = batch["observations"].shape[0]
        return type(batch)((k, v if k == "times" else self.rows(v, n)) for k, v in batch.items())

    def block(self, x, B, K, pad=None):
        """This rank's block [Bd, Ks, ...] of ``x[B, K, ...]``: its rows and
        its samples, padded with copies of row and sample 0, or with ``pad``
        where given."""
        rows, real_rows = _span_index(B, self.shape["data"], self.data_index, x.device)
        cols, real_cols = _span_index(K, self.shape["sample"], self.sample_index, x.device)
        out = x.index_select(0, rows).index_select(1, cols)
        if pad is not None:
            real = (real_rows[:, None] & real_cols[None, :]).reshape(
                out.shape[:2] + (1,) * (out.dim() - 2))
            out = torch.where(real, out, torch.full_like(out, pad))
        return out

    def real(self, B, K, device):
        """[Bd, Ks] bool: which entries of this rank's block are not padding."""
        _, real_rows = _span_index(B, self.shape["data"], self.data_index, device)
        _, real_cols = _span_index(K, self.shape["sample"], self.sample_index, device)
        return real_rows[:, None] & real_cols[None, :]

    def assemble(self, blocks, B, K):
        """``x[B, K, ...]`` from every rank's block, in rank order."""
        n_sample = self.shape["sample"]
        grid = [torch.cat(blocks[d * n_sample:(d + 1) * n_sample], 1)
                for d in range(self.shape["data"])]
        return torch.cat(grid, 0)[:B, :K]

    # --------------------------------------------------------- collectives
    def gather(self, tensors, group):
        """All-gather a dict of float32 tensors (every member's of equal
        shapes) over ``group`` in one buffer: {name: [each member's tensor,
        in group rank order]}.  A group of one returns this rank's own."""
        if group is None:
            return {k: [v] for k, v in tensors.items()}
        names = list(tensors)
        flat = torch.cat([tensors[k].reshape(-1) for k in names])
        if self.gloo:
            flat = flat.cpu()
        t0 = time.perf_counter()
        parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, flat, group=group)
        STATS["collectives"] += 1
        STATS["seconds"] += time.perf_counter() - t0
        out = {k: [] for k in names}
        for part in parts:
            part = part.to(self.device)
            at = 0
            for k in names:
                v = tensors[k]
                out[k].append(part[at:at + v.numel()].view(v.shape))
                at += v.numel()
        return out

    def sum_samples(self, tensors):
        """The sample ranks' partial sums of each tensor, added in rank order."""
        return {k: _ordered_sum(v) for k, v in self.gather(tensors, self.sample_group).items()}

    def cat_rows(self, tensors, n):
        """The data ranks' rows ``[Bd, ...]`` of each tensor joined, the
        padding dropped: ``[n, ...]`` in row order."""
        got = self.gather(tensors, self.data_group)
        return {k: torch.cat(v, 0)[:n] for k, v in got.items()}

    def gather_blocks(self, blocks, B, K):
        """Every rank's block of each tensor of ``blocks`` assembled:
        {name: x[B, K, ...]} on every rank."""
        got = self.gather(blocks, self.world_group)
        return {k: self.assemble(v, B, K) for k, v in got.items()}


def _ordered_sum(parts):
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


class _Scatter(torch.autograd.Function):
    """This rank's blocks of the draws' tensors ``[B, K, ...]`` and copies of
    the decoder leaves the block reads.  Backward: one gather of every
    rank's block cotangents and leaf gradients; the draws' cotangents
    assembled whole, the leaves' summed in rank order."""

    @staticmethod
    def forward(ctx, mesh, B, K, n_draws, *tensors):
        ctx.mesh, ctx.B, ctx.K, ctx.n_draws = mesh, B, K, n_draws
        blocks = tuple(constrain_u(t, mesh) for t in tensors[:n_draws])
        leaves = tuple(t.clone() for t in tensors[n_draws:])
        ctx.shapes = [b.shape for b in blocks] + [t.shape for t in leaves]
        ctx.dtype, ctx.device = tensors[0].dtype, tensors[0].device
        return blocks + leaves

    @staticmethod
    def backward(ctx, *grads):
        mesh, n = ctx.mesh, ctx.n_draws
        # a missing gradient is a zero one (missing on every rank alike)
        grads = [g if g is not None else torch.zeros(shape, dtype=ctx.dtype, device=ctx.device)
                 for g, shape in zip(grads, ctx.shapes)]
        got = mesh.gather({i: g for i, g in enumerate(grads)}, mesh.world_group)
        draws = [mesh.assemble(got[i], ctx.B, ctx.K) for i in range(n)]
        leaves = [_ordered_sum(got[i]) for i in range(n, len(grads))]
        return (None, None, None, None, *draws, *leaves)


class _Gather(torch.autograd.Function):
    """Every rank's block of a tensor assembled whole ``[B, K, ...]`` on
    every rank.  Backward: this rank's block of the (replicated) cotangent,
    zero on padding."""

    @staticmethod
    def forward(ctx, mesh, B, K, block):
        ctx.mesh, ctx.B, ctx.K = mesh, B, K
        return mesh.gather_blocks({"x": block}, B, K)["x"]

    @staticmethod
    def backward(ctx, grad):
        return None, None, None, ctx.mesh.block(grad, ctx.B, ctx.K, pad=0.0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def shard_block(mesh, fn, params, draws, batch, K):
    """``fn(params, draws_block, batch_block, Ks)`` (a ``[Bd, Ks, ...]``
    tensor) run on this rank's block and assembled whole, ``[B, K, ...]``,
    on every rank.  ``draws``: a dict of ``[B, K]``-broadcastable tensors
    (expanded, then cut to the block); ``batch``: the batch, whose row
    tensors are cut to the block's rows (``times`` stays whole); ``params``:
    the (nested dict) params ``fn`` reads, their gradients summed over the
    ranks."""
    B = batch["observations"].shape[0]
    names = list(draws)
    full = [draws[n].expand((B, K) + tuple(draws[n].shape[2:])) for n in names]
    leaves = _leaves(params)
    outs = _Scatter.apply(mesh, B, K, len(names), *full, *leaves)
    block_draws = dict(zip(names, outs[:len(names)]))
    block_params = _rebuild(params, iter(outs[len(names):]))
    rows = mesh.batch_rows(batch)
    Ks = shard_span(K, mesh.shape["sample"], mesh.sample_index)[1]
    return _Gather.apply(mesh, B, K, fn(block_params, block_draws, rows, Ks))


_MESHES = {}


def make_mesh(n_data=None, n_sample=None, devices=None, device="cpu"):
    """A (data, sample) mesh over the ranks of the process group (``devices``:
    their count, default the world size; 1 without a process group).

    With no arguments every rank goes on the 'sample' axis (IWAE samples are
    the larger parallel axis at the reference's K=200/1000 regimes).  A mesh
    is made once per shape; its sub-groups live as long as the process group."""
    n = devices if devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if n_data is None and n_sample is None:
        n_data, n_sample = 1, n
    elif n_data is None:
        n_data = n // n_sample
    elif n_sample is None:
        n_sample = n // n_data
    assert n_data * n_sample == n, "mesh (%d, %d) != %d devices" % (n_data, n_sample, n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    key = (n_data, n_sample, rank, str(device))
    if key not in _MESHES:
        _MESHES[key] = Mesh(n_data, n_sample, rank=rank, device=device)
    return _MESHES[key]


def forget_meshes():
    """Drop the meshes made so far (their groups end with the process group)."""
    _MESHES.clear()


def constrain_u(u, mesh=None):
    """This rank's block of the draw ``u[B, K, ...]`` (rows over 'data',
    samples over 'sample'; ``shard_block`` cuts the draws this way); ``u``
    itself without a mesh of several ranks."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if mesh is None or mesh.size == 1:
        return u
    return mesh.block(u, u.shape[0], u.shape[1])


def batch_shardings(mesh, n, device="cpu"):
    """The indices of this rank's rows of a batch of ``n`` rows (its data
    shard; padding as row 0)."""
    return _span_index(n, mesh.shape["data"], mesh.data_index, device)[0]


def shard_step(step, mesh):
    """Wrap a step (``training.loss_fn`` and its backward, or
    ``dreg_value_and_grad``) to run with ``mesh`` ambient: its decoder
    block shards over the mesh, and the gradients it leaves are the whole
    batch's on every rank."""

    def sharded(*args, **kwargs):
        with use_mesh(mesh):
            return step(*args, **kwargs)

    return sharded
