"""Multi-device solves over `torch.distributed` (port of
`lego_loam_tpu/distributed.py`).

One process drives one device, and the process group is the mesh: a
`DeviceMesh` over the whole world, ranks laid out row-major as the
reference's `("graph", "map")` mesh lays out its devices. Each solver is
the reference's `shard_map` body run on every rank, with its named
collectives written out:

- `sharded_pose_graph_solver`: factors in row blocks over the ranks, poses
  replicated; each rank sums its factors' gradient, preconditioner and
  matvec terms and one `all_reduce` per sum adds the ranks' (the
  reference's nested psums over both mesh axes).
- `schur_pose_graph_solver`: poses and chain rels in contiguous blocks
  over a 1-D mesh ("seg"), loop factors replicated; four collectives a
  solve (the boundary rel row, the loop-factor offsets, the reduced
  system, the leader's solution).
- `sharded_map_gn_step`: the submap in row blocks, queries replicated; a
  local 5-NN per rank (kernel K2 on the card, at the site
  `mapping_sharded`), the candidates gathered in rank order and merged.
- `shard_backend_state`: the keyframe store and the assembled submap in
  row blocks over the ranks, by the rule of `backend_state_shardings`.
  A row-blocked leaf is a `RowBlock`: this rank's rows plus the mesh, so
  the state carries its layout as a sharded JAX array does, and the code
  downstream dispatches on the leaf. Where the reference lets GSPMD
  partition each access, the store helpers (`all_rows`, `gather_rows`,
  `write_row`, `set_rows`, `row_sum`, `top5_rows`) write each one out as a
  local operation plus its collective, with one code path for both layouts.

Divergences from the reference: a mesh spans the whole world (torch meshes
cover the process group), so `make_mesh` refuses another device count; a
store's reads are gathers (exact), so a sharded run gives the bits of the
unsharded one, where the reference's GSPMD sums in another order.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .config import LegoLoamConfig
from .math import se3
from .ops.knn import top5_l2
from .posegraph import (
    Factors,
    factor_jacobians,
    factor_residuals,
    factor_segments,
    gradient,
    hessian_blocks,
    hessian_times,
    precond_inverse,
    solve_dense_gn,
    solve_pose_graph,
)
from .types import map_leaves, named_leaves

TIMEOUT = datetime.timedelta(seconds=60)  # a rank that never arrives fails the run


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda"):
    """Join the process group; returns this rank's device.

    CUDA: NCCL, with this process bound to `cuda:$LOCAL_RANK` first (else
    process_id modulo the visible cards). CPU (when asked): gloo. Raises
    where the card or NCCL is missing; never falls back to gloo or the
    CPU. With a coordinator ("host:port"), the
    group meets there; without one, torch reads MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE and RANK from the environment (as torchrun sets them)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is visible (pass device='cpu' for gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this torch has no NCCL")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", (process_id or 0) % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_distributed: device {device!r} is neither 'cuda' nor 'cpu'")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes if num_processes else -1,
                            rank=process_id if process_id is not None else -1, timeout=TIMEOUT)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None):
    """A ("graph", "map") DeviceMesh over the whole world: (n/2, 2) when
    n >= 4 and even, else (n, 1), as the reference shapes its mesh. A
    count other than the world size is refused."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: a mesh spans the whole world of {n} ranks, not {n_devices}")
    shape = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
    return init_device_mesh(_device_type(), shape, mesh_dim_names=("graph", "map"))


def _position(mesh) -> int:
    """This rank's place in the mesh's flattened (row-major) order."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def _whole_group(mesh):
    """The group of every rank of the mesh: the world (`make_mesh` spans it)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the whole world")
    return dist.group.WORLD


def shard_rows(x, mesh):
    """This rank's row block of x (a tensor, or a NamedTuple of tensors
    such as `Factors`, field by field): rows [r F/n, (r+1) F/n) for the
    rank's flattened mesh position r, as P(("graph", "map")) splits the
    rows. F must divide by the mesh size."""
    if isinstance(x, tuple):
        return type(x)(*(shard_rows(v, mesh) for v in x))
    n, F = mesh.size(), x.shape[0]
    if F % n:
        raise ValueError(f"shard_rows: {F} rows do not divide over {n} ranks")
    r = _position(mesh)
    return x[r * F // n:(r + 1) * F // n]


def _all_reduce(x, group):
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x, group, n):
    """Every rank's x, concatenated along dim 0 in rank order (a bool
    tensor travels as bytes)."""
    if x.dtype == torch.bool:
        return _all_gather(x.view(torch.uint8), group, n).view(torch.bool)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def is_writer() -> bool:
    """Whether this process writes files: rank 0 of a process group, or a
    process outside any group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# The keyframe store in row blocks
# ---------------------------------------------------------------------------


class RowBlock:
    """This rank's row block of a leaf laid out in row blocks over a mesh
    (the reference's P(("graph", "map"))): rows [r K/n, (r+1) K/n) of the
    whole leaf's K, for the rank's flattened mesh position r. `shape` is
    the whole leaf's and `local` holds the block. Torch functions do not
    take it: the store helpers below read and write it."""

    __slots__ = ("local", "mesh", "rows", "start")

    def __init__(self, local, mesh, rows: int):
        self.local, self.mesh, self.rows = local, mesh, rows
        self.start = _position(mesh) * local.shape[0]

    @property
    def shape(self):
        return torch.Size((self.rows, *self.local.shape[1:]))

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def nbytes(self) -> int:
        return self.local.numel() * self.local.element_size()


def backend_state_shardings(mesh, state) -> dict:
    """Leaf by leaf (dotted names, `types.named_leaves`): "rows" for a leaf
    of the keyframe store (`kf_*`) or of the assembled submap (`submap.*`)
    whose leading axis divides over the mesh, else "replicated" (scalars,
    poses, `submap_center`, and any leaf that does not divide), the rule
    of the reference's `backend_state_shardings`."""
    n = mesh.size()

    def kind(name, leaf):
        if len(leaf.shape) and name.startswith(("kf_", "submap.")) and leaf.shape[0] % n == 0:
            return "rows"
        return "replicated"

    return {name: kind(name, leaf) for name, leaf in named_leaves(state)}


def shard_backend_state(mesh, state):
    """`state` with its row-blocked leaves (`backend_state_shardings`) as
    `RowBlock`s holding this rank's rows; the other leaves whole. A state
    already in row blocks is gathered first, so the call also re-lays a
    state out. Every rank of the mesh calls it."""
    kinds = backend_state_shardings(mesh, state)
    return map_leaves(state, lambda name, leaf: _block(all_rows(leaf), mesh) if kinds[name] == "rows"
                      else all_rows(leaf))


def laid_out_as(template, state):
    """`state` (whole leaves) laid out as `template` (a state of the same
    tree) is: where the template's leaf is a `RowBlock`, this rank's rows
    on its mesh."""
    old = dict(named_leaves(template))
    return map_leaves(state, lambda name, leaf: _block(leaf, old[name].mesh) if isinstance(old[name], RowBlock)
                      else leaf)


def _block(whole, mesh):
    block = shard_rows(whole, mesh)
    # a copy, so that the whole leaf can be freed; at one rank the block is the whole
    return RowBlock(block.clone() if block.shape[0] < whole.shape[0] else block, mesh, whole.shape[0])


def _gather_blocks(x, mesh):
    """Every rank's x concatenated along dim 0 in mesh order (one
    all_gather over the world)."""
    n = mesh.size()
    parts = _all_gather(x, _whole_group(mesh), n).reshape(n, *x.shape)
    order = mesh.mesh.flatten().tolist()
    if order != list(range(n)):
        parts = parts[torch.tensor(order, device=x.device)]
    return parts.reshape(n * x.shape[0], *x.shape[1:])


def all_rows(leaf):
    """The whole leaf in slot order: the tensor itself, or every rank's
    block gathered."""
    if not isinstance(leaf, RowBlock):
        return leaf
    return _gather_blocks(leaf.local, leaf.mesh)


def gather_rows(leaf, idx):
    """Rows `idx` (a 1-D int tensor of slots, the same on every rank) of the
    leaf, in idx order. Row blocks: each rank takes the rows it holds
    (clamped where it holds none), one all_gather, and each row is read
    from its owner's part."""
    idx = idx.long()
    if not isinstance(leaf, RowBlock):
        return leaf.index_select(0, idx)
    if not idx.numel():  # the same on every rank: no collective
        return leaf.local[:0].clone()
    b = leaf.local.shape[0]
    mine = leaf.local.index_select(0, torch.clamp(idx - leaf.start, 0, b - 1))
    parts = _gather_blocks(mine, leaf.mesh).reshape(leaf.mesh.size(), *mine.shape)
    return parts[idx // b, torch.arange(idx.shape[0], device=idx.device)]


def write_row(leaf, slot, row, where):
    """Row `slot` (a (1,) int tensor) of the leaf becomes `row` where the
    bool tensor `where` holds and keeps its value elsewhere, in place and
    decided on the device (no host read). Row blocks: the owner writes;
    every other rank rewrites one of its rows with itself."""
    slot = slot.long()
    buf = leaf
    if isinstance(leaf, RowBlock):
        buf, b = leaf.local, leaf.local.shape[0]
        local = slot - leaf.start
        where = where & (local[0] >= 0) & (local[0] < b)
        slot = torch.clamp(local, 0, b - 1)
    buf.index_copy_(0, slot, torch.where(where, row, buf.index_select(0, slot)[0])[None])


def set_rows(leaf, whole):
    """The leaf takes `whole`'s rows in place (every rank passes the same
    whole leaf); a block copies its own rows."""
    if isinstance(leaf, RowBlock):
        leaf.local.copy_(whole[leaf.start:leaf.start + leaf.local.shape[0]])
    else:
        leaf.copy_(whole)


def assign(dst, src):
    """dst takes src's values in place (a block its block's rows): the
    state's buffers keep their addresses, which a captured frame step
    reads and writes."""
    if dst is src:
        return
    if isinstance(dst, RowBlock):
        dst.local.copy_(src.local)
    else:
        dst.copy_(src)


def assign_state(dst, src):
    """Every leaf of the state `dst` takes the matching leaf of `src` in
    place (`assign`)."""
    for (_, d), (_, s) in zip(named_leaves(dst), named_leaves(src)):
        assign(d, s)


def row_sum(leaf):
    """The sum of every element of the leaf; over row blocks, each rank's
    sum all-reduced (exact for the integer sums of masks)."""
    if not isinstance(leaf, RowBlock):
        return leaf.sum()
    return _all_reduce(leaf.local.sum(), _whole_group(leaf.mesh))


def _merge_top5(q, xyz, mask, mesh, site):
    """The 5 nearest unmasked points of each query among the row blocks of
    a target over the mesh, each rank passing its block: K2 (`top5_l2`, at
    `site`) on the block, the candidates' d2 and coordinates gathered in
    mesh order and merged by a stable sort, so that equal d2 keep the lower
    global row, as `lax.top_k` does. Returns (d2 (Q, 5), points (Q, 5, 3)).
    An empty slot (d2 1e30) carries its block's row 0: the merge takes
    empties last and rank 0's first, so those it keeps are the whole
    target's row 0, where an unsharded search's clamped index points."""
    k = 5
    idx, d2 = top5_l2(q, xyz, mask, groups=1, site=site)
    cand = xyz[torch.clamp(idx, min=0).long()]  # (Q, 5, 3)
    Q, n = q.shape[0], mesh.size()
    merged = _gather_blocks(torch.cat([d2[..., None], cand], dim=-1)[None], mesh)  # (n, Q, 5, 4)
    merged = merged.permute(1, 0, 2, 3).reshape(Q, n * k, 4)
    order = torch.argsort(merged[..., 0], dim=1, stable=True)[:, :k]
    best = torch.gather(merged, 1, order[..., None].expand(-1, -1, 4))
    return best[..., 0], best[..., 1:]


def top5_rows(q, xyz, mask, site):
    """`_merge_top5` over a submap leaf in row blocks (`RowBlock`s of its
    points and mask)."""
    return _merge_top5(q, xyz.local, mask.local, xyz.mesh, site)


# ---------------------------------------------------------------------------
# Distributed pose graph
# ---------------------------------------------------------------------------


def sharded_pose_graph_solver(mesh, cfg: LegoLoamConfig, gn_iters: int = 3, prior_w: float = 1e6):
    """Returns solve(poses_R, poses_t, local_factors, active) -> (R, t).

    The poses (N, 3, 3)/(N, 3) and `active` (N,) are replicated; each rank
    passes its row block of the factor set (`shard_rows`). Whole-graph GN
    with block-Jacobi PCG, `cg_iterations` a GN step: the gradient, the
    preconditioner's blocks and each matvec are summed over the local
    factors and all-reduced; the CG itself runs replicated. Fixed loop
    counts and no host read."""
    group = _whole_group(mesh)

    def solve(poses_R, poses_t, f: Factors, active_mask):
        N = poses_R.shape[0]
        active = active_mask[:, None].to(poses_t.dtype)
        seg = factor_segments(f, N)
        R, t = poses_R, poses_t
        for _ in range(gn_iters):
            r = factor_residuals(R, t, f)
            Ji, Jj = factor_jacobians(R, t, f, r)
            b = -_all_reduce(gradient(Ji, Jj, r, f, seg), group) * active
            Minv = precond_inverse(_all_reduce(hessian_blocks(Ji, Jj, f, seg), group), prior_w)

            def mv(x):
                y = _all_reduce(hessian_times(x, Ji, Jj, f, seg), group)
                y[0] += prior_w * x[0]
                return y * active

            def apply_M(x):
                return torch.einsum("nab,nb->na", Minv, x) * active

            x = torch.zeros_like(b)
            res = b
            p = apply_M(res)
            rz = torch.sum(res * p)
            for _ in range(cfg.distributed.cg_iterations):
                Ap = mv(p)
                denom = torch.sum(p * Ap)
                alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
                x = x + alpha * p
                res = res - alpha * Ap
                z = apply_M(res)
                rz2 = torch.sum(res * z)
                beta = torch.where(torch.abs(rz) > 1e-12, rz2 / rz, 0.0)
                p = z + beta * p
                rz = rz2

            dR, dt = se3.exp_se3(x)
            keep = active_mask[:, None]
            R, t = (torch.where(keep[..., None], R @ dR, R),
                    torch.where(keep, torch.einsum("nij,nj->ni", R, dt) + t, t))
        return R, t

    return solve


# ---------------------------------------------------------------------------
# Schur-reduction distributed pose graph
# ---------------------------------------------------------------------------


def _pack(*xs):
    """Tensors with a common leading dimension as one (L, sum of widths)
    float tensor, so one collective carries them all."""
    return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)


def _unpack(flat, *shapes):
    out, c = [], 0
    for shape in shapes:
        w = 1
        for s in shape:
            w *= s
        out.append(flat[:, c:c + w].reshape(flat.shape[0], *shape))
        c += w
    return out


def schur_pose_graph_solver(mesh, cfg: LegoLoamConfig, n_poses: int, stride: int = 16, gn_iters: int = 3,
                            prior_w: float = 1e6, reduced: str = "auto"):
    """Chain + loop pose-graph solve by segment reduction over a 1-D mesh.

    Poses and chain rels lie in contiguous blocks of n_poses / n ranks
    (rel[l] measures pose l-1 -> l, identity at l = 0); loop factors
    (absolute pose ids) are replicated. Returns solve(R_loc, t_loc,
    relR_loc, relt_loc, n_active, loop) -> this rank's (R, t). Four
    collectives a solve, none in a loop:

    1. an all_gather of each rank's first rel row: a rank's last segment
       needs the next rank's first rel (the reference's ppermute);
    2. an all_reduce of the loop factors' intra-segment offsets, each
       contributed by the rank that owns the pose;
    3. an all_gather of the reduced system (anchor poses and the composed
       segment factors);
    4. a broadcast of the reduced solution, solved once on the mesh's
       first rank: dense GN (`solve_dense_gn`) for reduced="dense", PCG
       (`solve_pose_graph`) for "pcg", "auto" dense up to 256 anchors.

    Each pose then takes its segment's anchor corrections, blended
    geodesically, with no further communication."""
    axis = mesh.mesh_dim_names[0]
    group = mesh.get_group(axis)
    nd = mesh.size()
    if n_poses % (nd * stride):
        raise ValueError(f"schur_pose_graph_solver: n_poses {n_poses} does not divide into {nd} ranks x stride "
                         f"{stride}")
    d = mesh.get_local_rank(axis)
    leader = dist.get_global_rank(group, 0)
    P_loc = n_poses // nd
    A_loc = P_loc // stride
    A_tot = A_loc * nd
    base = d * P_loc
    m = cfg.mapping
    use_dense = reduced == "dense" or (reduced == "auto" and A_tot <= 256)

    def solve(R_loc, t_loc, relR_loc, relt_loc, n_active, loop: Factors):
        dev, f32 = t_loc.device, t_loc.dtype
        eye = torch.eye(3, dtype=f32, device=dev)
        n_active = torch.as_tensor(n_active, device=dev).to(torch.int64)

        # 1. the next rank's first rel row closes this rank's last segment
        rows = _all_gather(_pack(relR_loc[:1], relt_loc[:1]), group, nd)
        nbrR, nbrt = _unpack(rows[(d + 1) % nd:(d + 1) % nd + 1], (3, 3), (3,))
        segR = torch.cat([relR_loc[1:], nbrR]).reshape(A_loc, stride, 3, 3)
        segt = torch.cat([relt_loc[1:], nbrt]).reshape(A_loc, stride, 3)
        M_R, M_t = eye.expand(A_loc, 3, 3), relt_loc.new_zeros(A_loc, 3)
        for s in range(stride):
            M_R, M_t = se3.compose(M_R, M_t, segR[:, s], segt[:, s])
        Ra_loc, ta_loc = R_loc[::stride], t_loc[::stride]

        # 2. loop-factor offsets O = T_anchor^{-1} T_pose from the owning rank
        def local_offset(ids):
            ids = ids.long()
            local = (ids >= base) & (ids < base + P_loc)
            li = torch.clamp(ids - base, 0, P_loc - 1)
            ai = li // stride
            OR, Ot = se3.relative(Ra_loc[ai], ta_loc[ai], R_loc[li], t_loc[li])
            return torch.where(local[:, None, None], OR, 0.0), torch.where(local[:, None], Ot, 0.0)

        offsets = _all_reduce(_pack(*local_offset(loop.i), *local_offset(loop.j)), group)
        OiR, Oit, OjR, Ojt = _unpack(offsets, (3, 3), (3,), (3, 3), (3,))

        # 3. the reduced system, in rank order
        Ra, ta, MgR, Mgt = _unpack(_all_gather(_pack(Ra_loc, ta_loc, M_R, M_t), group, nd), (3, 3), (3,), (3, 3), (3,))

        n_anchors = torch.clamp((n_active + stride - 1) // stride, min=1)
        active_a = torch.arange(A_tot, device=dev) < n_anchors
        ci = torch.arange(A_tot - 1, device=dev)
        cj = ci + 1
        chain_info = torch.cat([
            torch.full((A_tot - 1, 3), 1.0 / (m.chain_rot_var * stride), dtype=f32, device=dev),
            torch.full((A_tot - 1, 3), 1.0 / (m.chain_trans_var * stride), dtype=f32, device=dev),
        ], dim=1)
        li, lj = loop.i.long(), loop.j.long()
        ai = torch.minimum(torch.clamp(li // stride, min=0), n_anchors - 1)
        aj = torch.minimum(torch.clamp(lj // stride, min=0), n_anchors - 1)
        lvalid = loop.mask & (li < n_active) & (lj < n_active) & (ai != aj)
        MR_, Mt_ = se3.compose(*se3.compose(OiR, Oit, loop.R, loop.t), *se3.inverse(OjR, Ojt))
        red = Factors(
            i=torch.cat([ci, ai]), j=torch.cat([cj, aj]),
            R=torch.cat([MgR[: A_tot - 1], MR_]), t=torch.cat([Mgt[: A_tot - 1], Mt_]),
            info=torch.cat([chain_info, loop.info]), mask=torch.cat([cj < n_anchors, lvalid]),
        )

        # 4. the leader solves the reduced system once; the others receive it
        if d == 0:
            if use_dense:
                Ra2, ta2 = solve_dense_gn(Ra, ta, red, active_a, gn_iters=gn_iters, prior_w=prior_w,
                                          trust_rot=m.posegraph_trust_rot, trust_trans=m.posegraph_trust_trans)
            else:
                Ra2, ta2 = solve_pose_graph(Ra, ta, red, active_a, cfg, gn_iters=gn_iters, prior_w=prior_w)
            sol = _pack(Ra2, ta2).contiguous()
        else:
            sol = torch.empty((A_tot, 12), dtype=f32, device=dev)
        dist.broadcast(sol, src=leader, group=group)
        Ra2, ta2 = _unpack(sol, (3, 3), (3,))

        # anchor corrections D_a = T_a' T_a^{-1}, blended over each segment
        DR, Dt = se3.compose(Ra2, ta2, *se3.inverse(Ra, ta))
        l_glob = base + torch.arange(P_loc, device=dev)
        a_of_l = torch.minimum(l_glob // stride, n_anchors - 1)
        a_next = torch.minimum(a_of_l + 1, n_anchors - 1)
        frac = (l_glob - a_of_l * stride).to(f32) / float(stride)
        dRn, dtn = se3.compose(DR[a_next], Dt[a_next], *se3.inverse(DR[a_of_l], Dt[a_of_l]))
        bR, bt = se3.exp_se3(se3.log_se3(dRn, dtn) * frac[:, None])
        DRl, Dtl = se3.compose(bR, bt, DR[a_of_l], Dt[a_of_l])
        R_new = se3.orthonormalize(DRl @ R_loc)
        t_new = torch.einsum("nij,nj->ni", DRl, t_loc) + Dtl
        live = l_glob < n_active
        return torch.where(live[:, None, None], R_new, R_loc), torch.where(live[:, None], t_new, t_loc)

    return solve


# ---------------------------------------------------------------------------
# Sharded scan-to-map matching
# ---------------------------------------------------------------------------


def sharded_map_gn_step(mesh, cfg: LegoLoamConfig):
    """Returns step(q_surf, q_mask, map_xyz, map_mask, R, t) -> (R, t): one
    6-DoF GN mapping iteration against a submap in row blocks over the
    ranks (each rank passes its block; queries and pose replicated).

    Each rank finds its block's 5 nearest candidates (`top5_l2`: kernel K2
    on the card, site `mapping_sharded`; ties keep the earlier target, as
    the reference's top_k does); the candidates are gathered in rank order
    (the reference's "map" gather inside its "graph" gather) and merged by
    a stable sort. The plane fits and the normal equations are replicated."""
    from .mapping import plane_fit_pca

    _whole_group(mesh)  # refuses a mesh that does not span the world

    def step(q_surf, q_mask, map_xyz, map_mask, R, t):
        q = q_surf @ R.T + t
        # an empty slot (d2 1e30) never passes the 5th-NN gate
        d2, nbr = _merge_top5(q, map_xyz, map_mask, mesh, "mapping_sharded")
        ok = q_mask & (d2[:, 4] < cfg.mapping.nn_valid_dist)

        n, d_off = plane_fit_pca(nbr)
        fitd = torch.abs(torch.einsum("qki,qi->qk", nbr, n) + d_off[:, None])
        plane_ok = torch.all(fitd < cfg.mapping.plane_valid_dist, dim=1)
        pd = torch.sum(n * q, dim=-1) + d_off
        qn = torch.linalg.norm(q, dim=-1)
        s = 1.0 - 0.9 * torch.abs(pd) / torch.sqrt(torch.clamp(qn, min=1e-9))
        w = torch.where(ok & plane_ok & (s > 0.1), s, 0.0)

        J = torch.cat([torch.cross(q, n, dim=-1), n], dim=-1) * w[:, None]
        r = pd * w
        H = J.T @ J
        g = J.T @ r
        evals, evecs = torch.linalg.eigh(H)
        keep = (evals >= cfg.mapping.eigen_threshold).to(H.dtype)
        ginv = torch.where(evals > 1e-9, 1.0 / torch.clamp(evals, min=1e-9), 0.0)
        delta = -(evecs @ ((evecs.T @ g) * ginv * keep))
        dR, dt = se3.exp_se3(delta)
        return se3.compose(dR, dt, R, t)

    return step
