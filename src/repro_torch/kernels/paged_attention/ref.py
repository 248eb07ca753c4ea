"""Plain-PyTorch oracle for one sequence: gather pages, then masked softmax
attention (counterpart of ``repro/kernels/paged_attention/ref.py``)."""
from __future__ import annotations

import torch


def ref_paged_attention(page_table: torch.Tensor, seq_len: torch.Tensor,
                        q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor) -> torch.Tensor:
    """page_table [max_pages] int; seq_len [1] int; q [n_kv, g, d]
    (pre-scaled); k/v_pages [n_pages, ps, n_kv, d] → out [n_kv, g, d]."""
    max_pages = page_table.shape[0]
    ps = k_pages.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(max_pages * ps, *k_pages.shape[2:])
    v = v_pages[idx].reshape(max_pages * ps, *v_pages.shape[2:])
    s = torch.einsum("hgd,phd->hgp", q, k.to(q.dtype))
    mask = (torch.arange(max_pages * ps, device=q.device)
            < seq_len[0])[None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("hgp,phd->hgd", p, v.to(q.dtype))
    return out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
