"""In-jit decomposition of the almg hot loop.

Timing ONE jitted call per measurement adds the per-dispatch cost to
every small op.  Inside the real solver the whole Newton step is a
single XLA program, so the honest per-op cost is what an op costs
BACK-TO-BACK ON DEVICE.  This script measures exactly
that: each component is chained K times through a lax.fori_loop inside
one jit (output feeds input, so nothing folds away), and the cost is
(t_chain - t_empty)/K.

Components: patch apply, level matvec, level smoother (FGMRES(m)+patch),
Schoeberl prolong/restrict, coarse solve, one FMG cycle, the full Schur
PC application — plus f32-cast variants of the leaf ops to size the
mixed-precision headroom before wiring it in.
"""

import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def chain_time(fn, x0, K=32, reps=3):
    """Best-of-reps time of K chained applications inside one jit."""
    import jax
    from jax import lax

    @jax.jit
    def run(x):
        return lax.fori_loop(0, K, lambda i, v: fn(v), x)

    jax.block_until_ready(run(x0))  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x0))
        best = min(best, time.perf_counter() - t0)
    return best / K


def emit(out, key, val):
    out[key] = val
    print(json.dumps({key: val}), flush=True)


def main(nref=2):
    import jax
    import jax.numpy as jnp

    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    solver = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(16), nref=nref, k=2,
        solver_type="almg", hierarchy="uniform", gamma=1e4,
        verbose=False)
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 100.0
    params = solver.params()
    vmg = solver.vmg
    L = vmg.nlevels - 1
    static = solver._almg_static
    tstate = solver._transfer_setup(params)

    state = jax.jit(
        lambda z, p: vmg.setup(z[0], p, schoeberl_state=tstate,
                               static=static, p_fine=z[1])
    )(solver.z, params)
    jax.block_until_ready(state)

    lev = vmg.levels[L]
    shape = (lev.V.ndof, vmg.d)
    v0 = lev.mask_u * jnp.ones(shape, dtype=jnp.float64)
    r0 = v0.reshape(-1)
    out = {"nref": nref, "ndof_fine_u": int(lev.V.ndof * vmg.d),
           "npatches": int(vmg.patchsets[L - 1].npatches),
           "m_patch": int(vmg.patchsets[L - 1].m)}

    # dispatch overhead baseline
    t_empty = chain_time(lambda v: v + 1.0, r0, K=1)
    emit(out, "dispatch_ms", round(t_empty * 1e3, 3))

    lufac = state["patch_lufacs"][L - 1]
    _, papply = vmg.patch_solvers[L - 1]
    emit(out, "patch_apply_ms", round(
        chain_time(lambda r: papply(lufac, r), r0) * 1e3, 3))

    tensors = state["tensors"][L]
    if isinstance(tensors, dict):
        # gamma-split mixed-precision state (mg_dtype=f32): the leaf
        # timings below want ONE dense per-cell tensor; rebuild the
        # summed batch-major operator for the f32/f64 core comparison
        M64 = tensors["M"].astype(jnp.float64)
        B64 = tensors["B"].astype(jnp.float64)
        nld = lev.rows.shape[1]
        if M64.shape[-1] != nld:  # cell-minor (t-layout) state
            M64 = jnp.moveaxis(M64, -1, 0)
            B64 = jnp.transpose(B64, (2, 1, 0))
        tensors = (M64 + tensors["gamma"].astype(jnp.float64)
                   * jnp.einsum("cip,cjp->cij", B64, B64))
    ften = state["ftensors"][L]
    emit(out, "level_apply_ms", round(chain_time(
        lambda v: vmg.level_apply(L, tensors, v, ftensors=ften),
        v0) * 1e3, 3))

    emit(out, "smooth_ms", round(chain_time(
        lambda v: vmg._smooth(L, state, v, jnp.zeros_like(v)),
        v0) * 1e3, 3))

    emit(out, "transfer_roundtrip_ms", round(chain_time(
        lambda v: vmg._prolong(L - 1, state,
                               vmg._restrict(L - 1, state, v) * 0.5),
        v0) * 1e3, 3))

    b0 = (vmg.levels[0].mask_u
          * jnp.ones((vmg.levels[0].V.ndof, vmg.d),
                     dtype=jnp.float64)).reshape(-1)
    emit(out, "coarse_solve_ms", round(chain_time(
        lambda b: vmg.coarse_apply(state["coarse_fac"], b), b0) * 1e3, 3))

    emit(out, "fmg_cycle_ms", round(chain_time(
        lambda v: vmg.fmg(state, v), v0) * 1e3, 3))

    from alfi_tpu.solvers.fieldsplit import SchurPC
    pc = SchurPC(solver.form, solver.bcset.mask[0],
                 vmg.make_solve_A(state)).make_apply(params)

    def pc_chain(z):
        u, p = pc(z)
        return (u, p)

    q0 = jnp.ones((solver.Z.Q.ndof,), dtype=jnp.float64)
    emit(out, "schur_pc_apply_ms", round(
        chain_time(pc_chain, (v0, q0)) * 1e3, 3))

    from alfi_tpu.solvers.linear import make_jacobian_matvec
    J = make_jacobian_matvec(solver.form.residual, solver.bcset,
                             solver.z, params)
    emit(out, "jacobian_matvec_ms", round(
        chain_time(lambda z: J(z), (v0, q0)) * 1e3, 3))

    # ---- f32 leaf variants (mixed-precision headroom) ----
    from alfi_tpu.mg.patches import _gather_scatter
    gather, scatter = _gather_scatter(vmg.patchsets[L - 1])
    if not isinstance(lufac, (tuple, dict)):
        inv32 = lufac.astype(jnp.float32)
        if lufac.shape[0] == lufac.shape[1]:  # patch-minor (m, m, np)
            def papply32(r):
                rp = gather(r).T
                xp = jnp.sum(inv32 * rp[None, :, :], axis=1)
                return scatter(xp.T, r.dtype)
        else:  # batch-major (np, m, m)
            def papply32(r):
                xp = jnp.einsum("pij,pj->pi", inv32, gather(r))
                return scatter(xp, r.dtype)
        emit(out, "patch_apply_f32_ms", round(chain_time(
            papply32, r0.astype(jnp.float32)) * 1e3, 3))

    t32 = tensors.astype(jnp.float32)
    rows = lev.rows
    rs = lev.row_sum

    def level32(v):
        vloc = v[rows]
        rloc = jnp.einsum("cij,cj->ci", t32, vloc)
        return rs(rloc) if rs is not None else v

    emit(out, "level_apply_f32_core_ms", round(
        chain_time(level32, r0.astype(jnp.float32)) * 1e3, 3))

    def level64(v):
        vloc = v[rows]
        rloc = jnp.einsum("cij,cj->ci", tensors, vloc)
        return rs(rloc) if rs is not None else v

    emit(out, "level_apply_f64_core_ms", round(
        chain_time(level64, r0) * 1e3, 3))

    # ---- stage decomposition of the two hot ops (f32) ----
    # Which piece is the time: the gather, the contraction, or the
    # gather-sum?  Each stage is timed alone by chaining it through a
    # reduction back to the stage's own input shape.
    ps = vmg.patchsets[L - 1]
    r32 = r0.astype(jnp.float32)
    # anti-DCE: feed each stage's result back through a *1e-30 add so
    # the chain carries a real data dependency but the value stays put
    emit(out, "patch_gather_only_ms", round(
        chain_time(lambda r: r + 1e-30 * gather(r).sum(), r32)
        * 1e3, 3))

    if not isinstance(lufac, (tuple, dict)):
        rp0 = gather(r32)
        if lufac.shape[0] == lufac.shape[1]:
            inv32_t = lufac.astype(jnp.float32)
            emit(out, "patch_gemv_only_t_ms", round(chain_time(
                lambda rp: jnp.sum(inv32_t * rp.T[None, :, :],
                                   axis=1).T, rp0) * 1e3, 3))
        else:
            inv32b = lufac.astype(jnp.float32)
            emit(out, "patch_gemv_only_ms", round(chain_time(
                lambda rp: jnp.einsum("pij,pj->pi", inv32b, rp),
                rp0) * 1e3, 3))
        xp0 = jnp.ones_like(rp0)
        emit(out, "patch_scatter_only_ms", round(chain_time(
            lambda xp: xp + 1e-30 * scatter(xp, jnp.float32).sum(),
            xp0) * 1e3, 3))

    v32 = r0.astype(jnp.float32)
    emit(out, "level_gather_only_ms", round(
        chain_time(lambda v: v + 1e-30 * v[rows].sum(), v32)
        * 1e3, 3))
    vloc0 = v32[rows]
    emit(out, "level_einsum_only_ms", round(chain_time(
        lambda vl: jnp.einsum("cij,cj->ci", t32, vl), vloc0) * 1e3, 3))
    if rs is not None:
        rloc0 = jnp.ones_like(vloc0)
        emit(out, "level_rowsum_only_ms", round(chain_time(
            lambda rl: rl + 1e-30 * rs(rl).sum(), rloc0) * 1e3, 3))

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
