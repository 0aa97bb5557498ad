"""Plain PyTorch version of the fused CUR matmul."""


def cur_matmul_ref(x, cu, r):
    """y = (x @ CU) @ R in f32. x (M, m); cu (m, rk); r (rk, n) -> (M, n)."""
    t = x.float() @ cu.float()
    return (t @ r.float()).to(x.dtype)


def cur_chain_ref(x, c, u, r):
    """Unfolded healing-form chain: y = ((x @ C) @ U) @ R."""
    t = x.float() @ c.float()
    t = t @ u.float()
    return (t @ r.float()).to(x.dtype)
