"""Plain PyTorch versions of the Hopper kernels (standalone; no kernel imports).

Each one is the function its kernel computes, written naively on purpose:
inputs are cast to fp32 and contracted by one matmul/einsum with TF32 off,
so the result is a full-fp32 accumulation of the same products the kernel
sums, laid out (contiguous) as the kernel writes it.  The selective scan is
its step recurrence, one Python step per time step.  The wrappers in this
package run them for tensors that lie on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def ttm_interior_ref(u: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """out (A, R, B) = einsum('rn,anb->arb')."""
    return torch.einsum("rn,anb->arb", u.float(), x3.float()).contiguous()


def ttt_ref(x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """z (I, R) = einsum('aib,arb->ir')."""
    return torch.einsum("aib,arb->ir", x3.float(), y3.float()).contiguous()


def gram_ref(x3: torch.Tensor) -> torch.Tensor:
    return ttt_ref(x3, x3)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``csrc/ttt.cu`` rounds (``cvt.rna.tf32.f32`` on
    finite values): half a TF32 unit is added to the magnitude's bits, then
    the 13 low bits are cleared."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def ttt_tf32x3_ref(x3: torch.Tensor, y3: torch.Tensor, products: int = 3,
                   splits: int = 1) -> torch.Tensor:
    """The split-TF32 arithmetic of the wide route of ``csrc/ttt.cu``
    written out in PyTorch, for the tests (the kernels never call it):
    every operand v becomes hi = rna_tf32(v) and
    lo = rna_tf32(v - hi), and z = hi_x·hi_yᵀ + hi_x·lo_yᵀ + lo_x·hi_yᵀ
    (products = 3; products = 1 keeps hi_x·hi_yᵀ alone, one TF32 product),
    each product exact in fp32 and summed in fp32 over ``splits`` equal
    chunks of a, as the kernel's split reduction does."""
    x, y = x3.float(), y3.float()
    xh, yh = tf32_rna(x), tf32_rna(y)
    terms = [(xh, yh)]
    if products == 3:
        terms += [(xh, tf32_rna(y - yh)), (tf32_rna(x - xh), yh)]
    z = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32,
                    device=x.device)
    for part in torch.arange(x.shape[0]).tensor_split(splits):
        lo, hi = int(part[0]), int(part[-1]) + 1
        for p, q in terms:
            z += ttt_ref(p[lo:hi], q[lo:hi])
    return z


def grid_split(v: torch.Tensor, bits: int, dim: int, stage: int = 32):
    """``v`` (fp32) split as the wide route splits an fp32 operand:
    ``(hi, lo)`` with hi the value rounded to nearest (ties to even) on the
    grid 2^(e - bits) of its group -- ``stage`` consecutive entries along
    ``dim``, whose magnitudes are below 2^e -- and lo = rna_tf32(v - hi)."""
    v = v.float()
    k = v.shape[dim]
    vm = torch.nn.functional.pad(v.movedim(dim, -1), (0, -k % stage))
    groups = vm.reshape(*vm.shape[:-1], -1, stage).double()
    _, e = torch.frexp(groups.abs().amax(-1, keepdim=True))
    unit = torch.exp2((e - bits).double())
    hi = (torch.round(groups / unit) * unit).reshape(vm.shape)[..., :k]
    hi = hi.movedim(-1, dim).float()
    return hi, tf32_rna(v - hi)


#: bits of u's and x's hi parts over their group's bound (csrc/wgmma.cuh
#: U_BITS, X_BITS)
U_BITS, X_BITS = 11, 10


def matmul_tf32x3_ref(a: torch.Tensor, b: torch.Tensor, products: int = 3,
                      stage: int = 32, truncate: bool = False,
                      scheme: str = "stage", side: str = "first"
                      ) -> torch.Tensor:
    """The arithmetic of the wide route of ``csrc/wgmma.cuh`` (the boundary
    GEMM's and the interior TTM's at R > 16) written out in PyTorch, for the
    tests (the kernels never call it): C = a @ b as hi_a·hi_b + hi_a·lo_b +
    lo_a·hi_b of a split of every operand (products = 3; products = 1 keeps
    hi_a·hi_b alone, one TF32 product of the operands as they are, which is
    exact for bf16 operands).

    The kernel sums on the tensor cores, whose fp32 accumulator truncates;
    here each 8-deep ``wgmma`` step adds its exact products to the
    accumulator and rounds the result to fp32 -- to nearest, or toward zero
    with ``truncate``, as the card does.  The ``scheme`` is the split and
    how the sums are grouped:

    * ``"grid"`` (the kernels'): hi is each value rounded on its group's
      grid (:func:`grid_split`: ``U_BITS`` over the bound of a's row in a
      stage, ``X_BITS`` over b's column), so a stage's hi·hi products are
      whole units whose sum the accumulator holds exactly (below 2^24
      units); each stage's hi·hi is summed there from zero and added in
      fp32, and the cross terms (lo_a·hi_b, then hi_a·lo_b a k-step) run in
      one accumulator over the whole depth, added last.  Truncated, the
      energy of C stays within ~5e-9 of itself.
    * ``"stage"`` (the route before it, and the default): hi =
      rna_tf32(v); each ``stage``
      of k is summed from zero in the accumulator, in the old kernel's order
      (per k-step hi·lo and lo·hi, then every hi·hi), and the stages are
      added in fp32.  Truncated, that biases the sums toward zero: the
      energy of C falls by about 2e-7 of itself.

    ``side`` says which operand is u: ``"first"`` (the first mode, a = u
    (R, K), b = x (K, N)) or ``"last"`` (the last mode, a = x (M, K), b =
    uᵀ (K, R)), which the kernel runs as Cᵀ = u @ xᵀ: the same sums,
    transposed."""
    if side not in ("first", "last"):
        raise ValueError(f"side must be 'first' or 'last', got {side!r}")
    if side == "last":
        return matmul_tf32x3_ref(b.T, a.T, products, stage, truncate,
                                 scheme).T.contiguous()
    if scheme not in ("stage", "grid"):
        raise ValueError(f"scheme must be 'stage' or 'grid', got {scheme!r}")
    a, b = a.float(), b.float()
    add = _round_toward_zero if truncate else (lambda v: v.float())
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    if scheme == "grid":
        if products == 3:
            ah, al = grid_split(a, U_BITS, 1, stage)
            bh, bl = grid_split(b, X_BITS, 0, stage)
        else:
            ah, bh = a, b
        cross = torch.zeros_like(c)
        for k0 in range(0, a.shape[1], stage):
            part = torch.zeros_like(c)
            for k in range(k0, min(k0 + stage, a.shape[1]), 8):
                ks = slice(k, k + 8)
                if products == 3:
                    for p, q in ((al, bh), (ah, bl)):
                        cross = add(cross.double()
                                    + p[:, ks].double() @ q[ks].double())
                part = add(part.double() + ah[:, ks].double() @ bh[ks].double())
            c += part
        return c + cross if products == 3 else c
    ah, bh = tf32_rna(a), tf32_rna(b)
    terms = [(ah, bh)]
    if products == 3:
        terms = [(ah, tf32_rna(b - bh)), (tf32_rna(a - ah), bh), (ah, bh)]
    for k0 in range(0, a.shape[1], stage):
        k1 = min(k0 + stage, a.shape[1])
        part = torch.zeros_like(c)
        if not truncate:
            for p, q in terms:
                part += p[:, k0:k1] @ q[k0:k1]
        else:
            steps = range(k0, k1, 8)
            order = [(p, q, k) for k in steps for p, q in terms[:-1]] + \
                [(*terms[-1], k) for k in steps]
            for p, q, k in order:
                part = add(part.double() + p[:, k:min(k + 8, k1)].double()
                           @ q[k:min(k + 8, k1)].double())
        c += part
    return c


def ttm_tf32x3_ref(u: torch.Tensor, x3: torch.Tensor, products: int = 3,
                   truncate: bool = True, scheme: str = "grid"
                   ) -> torch.Tensor:
    """The wide route of ``csrc/ttm.cu`` (R > 16) written out in PyTorch,
    for the tests: out[a] = u @ x3[a] for every a, each entry by
    :func:`matmul_tf32x3_ref`'s arithmetic -- by default the kernel's own:
    the grid split, each stage's hi·hi summed exactly on the truncating
    accumulator and added in fp32, the cross terms in one accumulator.
    The contracted axis is the same for every a, so the batch runs as one
    product over the columns of all values of a."""
    a, i, b = x3.shape
    cols = x3.float().transpose(0, 1).reshape(i, a * b)
    out = matmul_tf32x3_ref(u, cols, products, truncate=truncate,
                            scheme=scheme)
    return out.reshape(-1, a, b).transpose(0, 1).contiguous()


def _round_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` rounded to fp32 toward zero."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def ttm_full_ref(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Full mode-n TTM via explicit matricization."""
    xm = torch.movedim(x.float(), mode, 0).reshape(x.shape[mode], -1)
    y2 = torch.matmul(u.float(), xm)
    out_shape = (u.shape[0],) + tuple(x.shape[:mode]) + tuple(x.shape[mode + 1:])
    return torch.movedim(y2.reshape(out_shape), 0, mode)


def gram_full_ref(x: torch.Tensor, mode: int) -> torch.Tensor:
    xm = torch.movedim(x.float(), mode, 0).reshape(x.shape[mode], -1)
    return torch.matmul(xm, xm.T)


def s6_scan_ref(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan by its step recurrence (the body of the
    reference's Pallas kernel, ``repro/kernels/s6_scan.py:37-45``), from
    the state ``h0`` (zeros when None):

        h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) ⊗ B_t,   y_t = h_t · C_t

    x, dt: (B, T, Di); bmat, cmat: (B, T, N); a: (Di, N); h0: (B, Di, N).
    Returns y (B, T, Di) and the final state (B, Di, N), both fp32."""
    x, dt, bmat, cmat, a = (v.float() for v in (x, dt, bmat, cmat, a))
    bsz, t, di = x.shape
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                     device=x.device)
         if h0 is None else h0.float().clone())
    y = torch.empty((bsz, t, di), dtype=torch.float32, device=x.device)
    dx = dt * x
    for i in range(t):
        da = torch.exp(dt[:, i, :, None] * a)
        h = da * h + dx[:, i, :, None] * bmat[:, i, None, :]
        y[:, i] = (h * cmat[:, i, None, :]).sum(-1)
    return y, h


def s6_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, a: torch.Tensor,
                        h0: torch.Tensor | None = None, *, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked route of ``csrc/s6_scan.cu`` written out in PyTorch, for
    the tests: the same function as :func:`s6_scan_ref`, in three phases
    over chunks of ``chunk`` steps.

    A. every chunk scans from a zero state: its local final state h_loc and
       its step sum S = Σ dt (the chunk's decay of state n is exp(a·S));
    B. the chunks are chained in order from h0: H_k = exp(a·S_k)·H_{k-1} +
       h_loc_k, which gives each chunk's entry state and the final state;
    C. every chunk rescans from its entry state and writes y.

    Every exponent is dt·a ≤ 0 or a·S ≤ 0, so no factor exceeds 1 (the
    reference's ``_s6_scan`` forms exp(-cumsum), which overflows).  The
    last chunk is padded with dt = x = 0, which leaves a state unchanged."""
    x, dt, bmat, cmat, a = (v.float() for v in (x, dt, bmat, cmat, a))
    bsz, t, di = x.shape
    n = a.shape[1]
    k = -(-t // chunk)
    pad = k * chunk - t

    def chunks(v):   # (B, T, W) -> (B, K, chunk, W), zero-padded
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        return v.reshape(bsz, k, chunk, v.shape[-1])

    xs, dts, bs, cs = (chunks(v) for v in (x, dt, bmat, cmat))
    dxs = dts * xs

    def scan(h, emit_y):
        ys = torch.empty((bsz, k, chunk, di), dtype=torch.float32,
                         device=x.device) if emit_y else None
        for i in range(chunk):
            h = (torch.exp(dts[:, :, i, :, None] * a) * h
                 + dxs[:, :, i, :, None] * bs[:, :, i, None, :])
            if emit_y:
                ys[:, :, i] = (h * cs[:, :, i, None, :]).sum(-1)
        return h, ys

    zero = torch.zeros((bsz, k, di, n), dtype=torch.float32, device=x.device)
    h_loc, _ = scan(zero, False)                               # phase A
    decay = torch.exp(dts.sum(2)[..., None] * a)               # (B, K, Di, N)
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    entry = torch.empty_like(h_loc)
    for j in range(k):                                         # phase B
        entry[:, j] = h
        h = decay[:, j] * h + h_loc[:, j]
    _, ys = scan(entry, True)                                  # phase C
    return ys.reshape(bsz, k * chunk, di)[:, :t].contiguous(), h
