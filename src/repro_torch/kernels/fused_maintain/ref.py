"""Plain PyTorch versions of the maintenance kernels (scatter_save,
arena_maintain, arena_scatter, fused_maintain): the same inputs and
outputs as their wrappers in ``kernel.py``. ``ops.py`` runs them on CPU
tensors."""
import torch

from repro_torch.core.blocks import (WORD_DTYPE_NAMES, leaf_block_view,
                                     leaf_block_words)


def scatter_save_ref(dst: torch.Tensor, src: torch.Tensor,
                     rows: torch.Tensor, block_rows: int) -> torch.Tensor:
    """``dst`` (R, W) with the selected blocks' rows overwritten from
    ``src``, in place; the ragged last block is clipped to R rows and
    duplicate ids rewrite the same values. Returns ``dst``."""
    n_rows = dst.shape[0]
    rows = rows.to(device=dst.device, dtype=torch.int64)
    row_idx = (rows[:, None] * block_rows
               + torch.arange(block_rows, device=dst.device)[None, :])
    row_idx = row_idx.reshape(-1)
    row_idx = row_idx[row_idx < n_rows]
    dst[row_idx] = src[row_idx]
    return dst


_CHUNK_TILES = 1 << 16      # tiles per step of the plain versions' loops


def decode_tiles(words: torch.Tensor, code: int) -> torch.Tensor:
    """(n, W) int32 words of dtype code ``code`` (core/blocks.py
    WORD_DTYPE_NAMES) -> (n, W * ratio) f32 values."""
    name = WORD_DTYPE_NAMES[code]
    # the unsigned 16/32-bit types convert through wider signed integers
    # (their own conversions are not on every device)
    if name == "uint16":
        return (words.view(torch.int16).to(torch.int32) & 0xFFFF) \
            .to(torch.float32)
    if name == "uint32":
        return (words.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    dtype = getattr(torch, name)
    if dtype.itemsize == 4:
        return words.view(dtype).to(torch.float32)
    bits = {1: torch.int8, 2: torch.int16}[dtype.itemsize]
    return words.view(bits).view(dtype).to(torch.float32)


def _xor_fold(acc: torch.Tensor, rows: torch.Tensor,
              values: torch.Tensor) -> None:
    """acc[rows[i]] ^= values[i] for every i, duplicates of a row folded
    (rank by rank: the k-th contribution of every row in one step)."""
    if rows.numel() == 0:
        return
    order = torch.argsort(rows, stable=True)
    rows, values = rows[order], values[order]
    _, counts = torch.unique_consecutive(rows, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=rows.device) \
        - torch.repeat_interleave(starts, counts)
    for k in range(int(counts.max())):
        sel = rank == k
        acc[rows[sel]] ^= values[sel]


def arena_maintain_ref(x: torch.Tensor, z, t: dict, parity=None,
                       replica=None):
    """Plain version of ``arena_maintain_cuda``: the same inputs, the same
    outputs (parity and replica written in place, scores returned)."""
    n_tiles = int(t["n_tiles"])
    xt = x.view(n_tiles, 1024)
    mem_ptr, mem_tile = t["mem_ptr"], t["mem_tile"].long()
    n_dest = t["dest_tile"].numel()
    counts = mem_ptr[1:] - mem_ptr[:-1]
    if parity is not None and n_dest:
        dest_of = torch.repeat_interleave(
            torch.arange(n_dest, device=x.device), counts)
        tail_ptr = t["tail_ptr"]
        tail_dest = torch.repeat_interleave(
            torch.arange(n_dest, device=x.device), tail_ptr[1:] - tail_ptr[:-1])
        par = parity.view(-1, 1024)
        for lo in range(0, n_dest, _CHUNK_TILES):
            hi = min(lo + _CHUNK_TILES, n_dest)
            acc = torch.zeros((hi - lo, 1024), dtype=torch.int32,
                              device=x.device)
            m0, m1 = int(mem_ptr[lo]), int(mem_ptr[hi])
            rows = dest_of[m0:m1] - lo
            _xor_fold(acc, rows, xt[mem_tile[m0:m1]])
            p0, p1 = int(tail_ptr[lo]), int(tail_ptr[hi])
            flat = acc.view(-1)
            pos = (tail_dest[p0:p1] - lo) * 1024 + t["tail_pos"][p0:p1].long()
            _xor_fold(flat, pos, x[t["tail_word"][p0:p1]])
            par[t["dest_tile"][lo:hi].long()] = acc
    if replica is not None:
        replica.view(n_tiles, 1024)[mem_tile] = xt[mem_tile]
    if z is None:
        return None
    zt = z.view(n_tiles, 1024)
    n_tb = t["tb_off"].numel()
    partials = torch.zeros((n_tiles + n_tb,), dtype=torch.float32,
                           device=x.device)
    codes = t["tile_code"].long()
    for lo in range(0, mem_tile.numel(), _CHUNK_TILES):
        tiles = mem_tile[lo:lo + _CHUNK_TILES]
        tc = codes[tiles]
        for c in torch.unique(tc).tolist():
            sel = tiles[tc == c]
            d = decode_tiles(xt[sel], c) - decode_tiles(zt[sel], c)
            partials[sel] = torch.sum(d * d, dim=1)
    for j in range(n_tb):
        off, n = int(t["tb_off"][j]), int(t["tb_len"][j])
        c = int(t["tb_code"][j])
        d = decode_tiles(x[None, off:off + n], c) \
            - decode_tiles(z[None, off:off + n], c)
        partials[n_tiles + j] = torch.sum(d * d)
    gid_ptr, gid_ab = t["gid_ptr"], t["gid_ab"].long()
    n_gid = gid_ptr.numel() - 1
    gid_of_ab = torch.empty_like(gid_ab)
    gid_of_ab[gid_ab] = torch.repeat_interleave(
        torch.arange(n_gid, device=x.device), gid_ptr[1:] - gid_ptr[:-1])
    nseg = t["ab_nseg"].long()
    seg0 = torch.repeat_interleave(t["ab_seg0"], nseg)
    seg = seg0 + torch.arange(seg0.numel(), device=x.device) \
        - torch.repeat_interleave(torch.cumsum(nseg, 0) - nseg, nseg)
    scores = torch.zeros((n_gid,), dtype=torch.float32, device=x.device)
    scores.index_add_(0, torch.repeat_interleave(gid_of_ab, nseg),
                      partials[seg])
    return scores


def arena_scatter_ref(dst: torch.Tensor, src: torch.Tensor,
                      t: dict) -> torch.Tensor:
    """Plain version of ``arena_scatter_cuda``: ``dst`` with the plan's word
    ranges ``[off[r], off[r] + len[r])`` copied from ``src``, in place."""
    for o, n in zip(t["off"].tolist(), t["len"].tolist()):
        dst[o:o + n] = src[o:o + n]
    return dst


def fused_maintain_ref(x: torch.Tensor, z, parity, t: dict,
                       block_rows: int, col: int, frame_elems: int,
                       replica=None):
    """Plain version of ``fused_maintain_cuda``, the torch form of the
    reference's ``_leaf_sweep_jnp``: the replica copy, per-block squared
    drift of f32 views, and the XOR of each row's members' packed words
    folded into ``parity`` (flat int32) at the row's group and the leaf's
    columns. Returns ``(replica, scores)`` (scores None without ``z``; the
    copy written into ``replica`` when given)."""
    replica = x.clone() if replica is None else replica.copy_(x)
    scores = None
    if z is not None:
        xv = leaf_block_view(x.to(torch.float32), block_rows)
        zv = leaf_block_view(z.to(torch.float32), block_rows)
        scores = torch.sum((xv - zv) ** 2, dim=1)
    if parity is not None:
        bits = leaf_block_words(x, block_rows)
        n_out, m_hat = int(t["n_out"]), int(t["m_hat"])
        members = t["members"].view(n_out, m_hat).long()
        contrib = torch.zeros((n_out, bits.shape[1]), dtype=torch.int32,
                              device=x.device)
        for i in range(m_hat):
            idx = members[:, i]
            ok = idx >= 0
            contrib[ok] ^= bits[idx[ok]]
        par = parity.view(-1, frame_elems)
        rows = t["touched"].long()
        par[rows, col:col + bits.shape[1]] ^= contrib
    return replica, scores
