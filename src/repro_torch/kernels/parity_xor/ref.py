"""Plain PyTorch version of the parity_xor kernel: the same inputs."""
import torch


def parity_xor_ref(out: torch.Tensor, src: torch.Tensor, base,
                   t: dict) -> torch.Tensor:
    """``out`` with every plan row written: the base words (or zeros), then
    each term XOR-ed in (XOR is order-free, so term by term is exact)."""
    row_out = t["row_out"].tolist()
    row_len = t["row_len"].tolist()
    row_base = t["row_base"].tolist()
    term_ptr = t["term_ptr"].tolist()
    dst, soff, n = (t["term_dst"].tolist(), t["term_src"].tolist(),
                    t["term_len"].tolist())
    for r, (o, length, b) in enumerate(zip(row_out, row_len, row_base)):
        row = out[o:o + length]
        if b >= 0:
            row.copy_(base[b:b + length])
        else:
            row.zero_()
        for k in range(term_ptr[r], term_ptr[r + 1]):
            row[dst[k]:dst[k] + n[k]] ^= src[soff[k]:soff[k] + n[k]]
    return out
