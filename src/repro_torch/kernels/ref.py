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
                   splits: int = 1, truncate: bool = False,
                   scheme: str | None = None) -> torch.Tensor:
    """The split-TF32 arithmetic of the wide route of ``csrc/ttt.cu``
    written out in PyTorch, for the tests (the kernels never call it):
    every operand v becomes hi = rna_tf32(v) and
    lo = rna_tf32(v - hi), and z = hi_x·hi_yᵀ + hi_x·lo_yᵀ + lo_x·hi_yᵀ
    (products = 3; products = 1 keeps hi_x·hi_yᵀ alone, one TF32 product),
    each product exact in fp32 and summed in fp32 over ``splits`` equal
    chunks of a, as the kernel's split reduction does.

    With ``truncate`` or a ``scheme`` the sums are the card's: each split
    runs :func:`matmul_tf32x3_ref`'s arithmetic on z = X·Yᵀ over the flat
    k = a·B + b (the plain-load route's stages of 32), its accumulator
    rounding toward zero when ``truncate``; ``scheme`` "stage" (the
    default here) is ``ttt.cu``'s own -- hi = rna_tf32(v), every stage
    summed from zero, its hi·lo and lo·hi products before its hi·hi --
    and "grid" the wide GEMM's of ``csrc/wgmma.cuh``."""
    x, y = x3.float(), y3.float()
    z = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32,
                    device=x.device)
    parts = torch.arange(x.shape[0]).tensor_split(splits)
    if truncate or scheme is not None:
        a, i, b = x.shape
        xm = x.transpose(0, 1).reshape(i, a * b)
        ym = y.transpose(0, 1).reshape(y.shape[1], a * b)
        for part in parts:
            ks = slice(int(part[0]) * b, (int(part[-1]) + 1) * b)
            z += matmul_tf32x3_ref(xm[:, ks], ym[:, ks].T, products,
                                   truncate=truncate,
                                   scheme=scheme or "stage")
        return z
    xh, yh = tf32_rna(x), tf32_rna(y)
    terms = [(xh, yh)]
    if products == 3:
        terms += [(xh, tf32_rna(y - yh)), (tf32_rna(x - xh), yh)]
    for part in parts:
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
                        h0: torch.Tensor | None = None, *, chunk: int,
                        checkpoints: int | None = None) -> tuple[torch.Tensor, ...]:
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
    last chunk is padded with dt = x = 0, which leaves a state unchanged.

    With ``checkpoints`` (a divisor of ``chunk``) phase C also keeps the
    state entering every ``checkpoints``-th step, as the kernel's phase C
    does for the backward, and the result is (y, h_final, ck) with ck
    (ceil(T / checkpoints), B, N, Di)."""
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

    every = checkpoints or chunk
    if chunk % every:
        raise ValueError(f"checkpoints ({every}) must divide chunk ({chunk})")
    ck = torch.empty((k, chunk // every, bsz, di, n), dtype=torch.float32,
                     device=x.device)

    def scan(h, emit_y):
        ys = torch.empty((bsz, k, chunk, di), dtype=torch.float32,
                         device=x.device) if emit_y else None
        for i in range(chunk):
            if emit_y and i % every == 0:
                ck[:, i // every] = h.transpose(0, 1)
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
    y = ys.reshape(bsz, k * chunk, di)[:, :t].contiguous()
    if checkpoints is None:
        return y, h
    ck = ck.reshape(-1, bsz, di, n)[:-(-t // every)]
    return y, h, ck.transpose(2, 3).contiguous()


def s6_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                    dy: torch.Tensor, dh_final: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`s6_scan_ref` by its reverse recurrence, as
    ``csrc/s6_scan_bwd.cu`` computes it: with every state h_t of the
    forward kept, the state's gradient runs back from ``dh_final`` (zeros
    when None),

        g_t = C_t ⊗ dy_t + exp(dt_{t+1} a) ⊙ g_{t+1},

    and gives dx_t = dt_t Σ_n g_t B_t, ddt_t = Σ_n g_t ⊙ (a exp(dt_t a) ⊙
    h_{t-1} + x_t B_t), dB_t = Σ_d g_t dt_t x_t, dC_t = Σ_d dy_t h_t,
    da = Σ_{b,t} g_t dt_t exp(dt_t a) ⊙ h_{t-1} and dh0 = exp(dt_1 a) ⊙ g_1.
    Returns (dx, ddt, dB, dC, da, dh0): dx in x's dtype, dB and dC in
    bmat's and cmat's, the rest fp32; every sum is fp32."""
    xf, dtf, bf, cf, af = (v.float() for v in (x, dt, bmat, cmat, a))
    dy = dy.float()
    bsz, t, di = xf.shape
    h = (torch.zeros((bsz, di, af.shape[1]), dtype=torch.float32,
                     device=xf.device)
         if h0 is None else h0.float())
    hs = [h]
    for i in range(t):
        h = (torch.exp(dtf[:, i, :, None] * af) * h
             + (dtf[:, i] * xf[:, i])[..., None] * bf[:, i, None, :])
        hs.append(h)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    carry = (torch.zeros_like(h) if dh_final is None
             else dh_final.float().clone())
    for i in range(t - 1, -1, -1):
        g = dy[:, i, :, None] * cf[:, i, None, :] + carry
        dec = torch.exp(dtf[:, i, :, None] * af)
        dh = dec * hs[i]
        dx[:, i] = dtf[:, i] * (g * bf[:, i, None, :]).sum(-1)
        ddt[:, i] = (g * (af * dh + xf[:, i, :, None]
                          * bf[:, i, None, :])).sum(-1)
        db[:, i] = (g * (dtf[:, i] * xf[:, i])[..., None]).sum(1)
        dc[:, i] = (dy[:, i, :, None] * hs[i + 1]).sum(1)
        da += (g * dtf[:, i, :, None] * dh).sum(0)
        carry = dec * g
    return (dx.to(x.dtype), ddt, db.to(bmat.dtype), dc.to(cmat.dtype), da,
            carry)


def s6_scan_bwd_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                            bmat: torch.Tensor, cmat: torch.Tensor,
                            a: torch.Tensor, h0: torch.Tensor | None,
                            dy: torch.Tensor,
                            dh_final: torch.Tensor | None = None, *,
                            chunk: int, states: torch.Tensor | None = None,
                            stride: int = 8, block: int = 128
                            ) -> tuple[torch.Tensor, ...]:
    """The algebra of ``csrc/s6_scan_bwd.cu`` written out in PyTorch, for
    the tests: the gradient of :func:`s6_scan_ref` (as
    :func:`s6_scan_bwd_ref` computes it) over chunks of ``chunk`` steps (a
    multiple of ``stride``), from the forward's checkpoints ``states``
    (ceil(T / stride), B, N, Di), the state entering every ``stride``-th
    step (from :func:`s6_scan_chunked_ref` with ``checkpoints``; kept here
    from the step recurrence when None).

    1. local: every chunk walks back from a zero carry, c ← exp(dt a) ⊙ (C
       dy + c): its carry out gl, and S = Σ dt (the chunk's decay
       exp(a·S));
    2. chain: G_in(k) = exp(a·S_{k+1}) ⊙ G_in(k+1) + gl_{k+1} from
       dh_final, and dh0 the carry out of chunk 0;
    3. chunk: from G_in(k), every sub-chunk of ``stride`` steps, last
       first, recomputes h_{t-1} from its checkpoint and walks back: g = C
       dy + c, dx, ddt, da's sum, dB and dC by blocks of ``block``
       channels, c ← exp(dt a) ⊙ g;
    4. the sums of dB and dC over the blocks and of da over (chunk, batch
       row) in order.
    The last chunk is padded with dt = x = dy = 0 and B = C = 0: a padded
    step passes the carry on unchanged and adds nothing."""
    xf, dtf, bf, cf, af = (v.float() for v in (x, dt, bmat, cmat, a))
    dyf = dy.float()
    bsz, t, di = xf.shape
    n = af.shape[1]
    if chunk % stride:
        raise ValueError(f"chunk ({chunk}) must be a multiple of stride "
                         f"({stride})")
    if states is None:
        h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=xf.device)
             if h0 is None else h0.float())
        kept = []
        for i in range(t):
            if i % stride == 0:
                kept.append(h.transpose(1, 2))
            h = (torch.exp(dtf[:, i, :, None] * af) * h
                 + (dtf[:, i] * xf[:, i])[..., None] * bf[:, i, None, :])
        states = torch.stack(kept)
    k = -(-t // chunk)
    pad = k * chunk - t

    def chunks(v):   # (B, T, W) -> (B, K, chunk, W), zero-padded
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        return v.reshape(bsz, k, chunk, v.shape[-1])

    xs, ds, ys, bs, cs = (chunks(v) for v in (xf, dtf, dyf, bf, cf))
    # 1. local carries and step sums
    c = torch.zeros((bsz, k, di, n), dtype=torch.float32, device=xf.device)
    for i in range(chunk - 1, -1, -1):
        c = torch.exp(ds[:, :, i, :, None] * af) * (
            cs[:, :, i, None, :] * ys[:, :, i, :, None] + c)
    decay = torch.exp(ds.sum(2)[..., None] * af)               # (B, K, Di, N)
    # 2. the chain from the last chunk
    g_in = torch.empty_like(c)
    carry = (torch.zeros((bsz, di, n), dtype=torch.float32, device=xf.device)
             if dh_final is None else dh_final.float())
    for j in range(k - 1, -1, -1):
        g_in[:, j] = carry
        carry = decay[:, j] * carry + c[:, j]
    dh0 = carry
    # 3. the chunk pass, every chunk at once
    ck = torch.zeros((k * chunk // stride, bsz, di, n), dtype=torch.float32,
                     device=xf.device)
    ck[:states.shape[0]] = states.transpose(2, 3)
    ck = ck.reshape(k, chunk // stride, bsz, di, n).permute(2, 0, 1, 3, 4)
    dx, ddt = (torch.empty((bsz, k, chunk, di), dtype=torch.float32,
                           device=xf.device) for _ in range(2))
    db, dc = (torch.empty((bsz, k, chunk, n), dtype=torch.float32,
                          device=xf.device) for _ in range(2))
    da = torch.zeros((bsz, k, di, n), dtype=torch.float32, device=xf.device)
    nblk = -(-di // block)

    def by_blocks(v):   # Σ over d of (B, K, Di, N) by blocks, then in order
        v = torch.nn.functional.pad(v, (0, 0, 0, nblk * block - di))
        part = v.reshape(bsz, k, nblk, block, n).sum(3)
        out = part[:, :, 0]
        for p in range(1, nblk):
            out = out + part[:, :, p]
        return out

    c = g_in
    for j in range(chunk // stride - 1, -1, -1):
        h = ck[:, :, j]                                        # (B, K, Di, N)
        hp = []
        for i in range(j * stride, (j + 1) * stride):
            hp.append(h)
            h = (torch.exp(ds[:, :, i, :, None] * af) * h
                 + (ds[:, :, i] * xs[:, :, i])[..., None] * bs[:, :, i, None, :])
        for i in range((j + 1) * stride - 1, j * stride - 1, -1):
            dv, xv, gy = ds[:, :, i], xs[:, :, i], ys[:, :, i]
            bn, cn = bs[:, :, i, None, :], cs[:, :, i, None, :]
            dec = torch.exp(dv[..., None] * af)
            hprev = hp[i - j * stride]
            g = cn * gy[..., None] + c
            dh = dec * hprev
            dx[:, :, i] = dv * (g * bn).sum(-1)
            ddt[:, :, i] = (g * (af * dh + xv[..., None] * bn)).sum(-1)
            da += g * dv[..., None] * dh
            db[:, :, i] = by_blocks(g * (dv * xv)[..., None])
            dc[:, :, i] = by_blocks(gy[..., None] * (dh + (dv * xv)[..., None] * bn))
            c = dec * g
    # 4. da over (chunk, batch row) in order
    da_sum = da[0, 0]
    for p in range(1, k * bsz):
        da_sum = da_sum + da[p % bsz, p // bsz]

    def steps(v):
        return v.reshape(bsz, k * chunk, -1)[:, :t].contiguous()

    return (steps(dx).to(x.dtype), steps(ddt), steps(db).to(bmat.dtype),
            steps(dc).to(cmat.dtype), da_sum, dh0)
