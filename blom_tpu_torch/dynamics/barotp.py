"""Split-explicit barotropic solver.

Counterpart of `blom_tpu/dynamics/barotp.py` (BLOM's
mod_barotp.F90:148-1003), as plain PyTorch: five weight blocks of
lstep/2 forward-backward substeps (mod_barotp.F90:328-358) advance the
barotropic state one baroclinic leap-frog interval and a further half to
predict the transport sums of the next step.  The substep loop is a
Python loop; the u/v solve order alternates with the substep parity
(mod_barotp.F90:381-384), and the two working time levels sit on a
leading axis of size 2 whose ml/nl roles follow the parity.

`make_substep` and `run_blocks` work on a bundle of 2-D fields with
injected shifts (`Shifts`), so the same substeps run on the global
fields (`barotp`) and on halo-widened blocks with an exchange every few
substeps (barotp_shmap.py, the reference's margin-2 trick of
mod_barotp.F90:387-397)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import onem, epsilp
from ..core.grid import Grid
from ..core.state import State
from ..ops import stencil
from .tmsmt import wbaro


class BarotpParams(NamedTuple):
    cwbdts: float = 0.0   # coastal wave-breaking damping 1/timescale [s-1]
    cwbdls: float = 25.0  # coastal wave-breaking damping length [m]
    mommth: str = 'enscon'


def _prologue(grid: Grid, s: State, utotn, vtotn, m: int, n: int,
              par: BarotpParams):
    """Per-baroclinic-step precomputation (mod_barotp.F90:168-346):
    velocity bounds, coastal damping, barotropic PV and the bundle of
    2-D fields the substeps use."""
    ip, iu, iv, iq = grid.ip, grid.iu, grid.iv, grid.iq
    im1, jm1 = grid.im1, grid.jm1

    # ---- velocity bounds and coastal damping (mod_barotp.F90:168-225)
    u_n_max = torch.amax(torch.clamp(s.u[n], min=0.), 0)
    u_n_min = torch.amin(torch.clamp(s.u[n], max=0.), 0)
    v_n_max = torch.amax(torch.clamp(s.v[n], min=0.), 0)
    v_n_min = torch.amin(torch.clamp(s.v[n], max=0.), 0)
    umaxb = (grid.umax - u_n_max) * s.pbu[m] * grid.scuy * iu
    uminb = (grid.umax + u_n_min) * s.pbu[m] * grid.scuy * iu
    vmaxb = (grid.vmax - v_n_max) * s.pbv[m] * grid.scvx * iv
    vminb = (grid.vmax + v_n_min) * s.pbv[m] * grid.scvx * iv
    uglue = par.cwbdts * torch.exp(1. - s.pbu[m] / (par.cwbdls * onem)) * iu
    vglue = par.cwbdts * torch.exp(1. - s.pbv[m] / (par.cwbdls * onem)) * iv

    # ---- potential vorticity of barotropic flow (mod_barotp.F90:227-286)
    # priority (lowest->highest): u(i,j-1), u(i,j), v(i-1,j), v(i,j),
    # interior
    pbp = torch.clamp(s.pb_p, min=epsilp)
    pvt = torch.zeros_like(pbp)
    pvt = torch.where(jm1(iu) > 0,
                      grid.corioq * 2. / (jm1(pbp) + im1(jm1(pbp))), pvt)
    pvt = torch.where(iu > 0, grid.corioq * 2. / (pbp + im1(pbp)), pvt)
    pvt = torch.where(im1(iv) > 0,
                      grid.corioq * 2. / (im1(pbp) + im1(jm1(pbp))), pvt)
    pvt = torch.where(iv > 0, grid.corioq * 2. / (pbp + jm1(pbp)), pvt)
    pvt = torch.where(iq > 0,
                      grid.corioq * 4.
                      / (pbp + im1(pbp) + jm1(pbp) + im1(jm1(pbp))), pvt)

    return {
        'ip': ip, 'iu': iu, 'iv': iv,
        'scuy': grid.scuy, 'scvx': grid.scvx, 'scp2i': grid.scp2i,
        'scuxi': grid.scuxi, 'scvyi': grid.scvyi,
        'scvxi': grid.scvxi, 'scuyi': grid.scuyi,
        'pvtrop_o': s.pvtrop[n], 'pvtrop_m': s.pvtrop[m],
        'pvtrop_n': pvt,
        'pgfxm_o': s.pgfxm_o, 'pgfym_o': s.pgfym_o,
        'xixp_o': s.xixp_o, 'xixm_o': s.xixm_o,
        'xiyp_o': s.xiyp_o, 'xiym_o': s.xiym_o,
        'pgfxm_m': s.pgfxm[m], 'pgfxm_n': s.pgfxm[n],
        'pgfym_m': s.pgfym[m], 'pgfym_n': s.pgfym[n],
        'xixp_m': s.xixp[m], 'xixp_n': s.xixp[n],
        'xixm_m': s.xixm[m], 'xixm_n': s.xixm[n],
        'xiyp_m': s.xiyp[m], 'xiyp_n': s.xiyp[n],
        'xiym_m': s.xiym[m], 'xiym_n': s.xiym[n],
        'utotn': utotn, 'vtotn': vtotn,
        'uglue': uglue, 'vglue': vglue,
        'umaxb': umaxb, 'uminb': uminb,
        'vmaxb': vmaxb, 'vminb': vminb,
        'pb_t': s.pb_mn, 'ubflx_t': s.ubflx_mn, 'vbflx_t': s.vbflx_mn,
    }


class Shifts(NamedTuple):
    im1: object
    ip1: object
    jm1: object
    jp1v: object    # j+1 read of a v-grid vector (fold-aware globally)
    jp1q: object    # j+1 read of a q-grid scalar


def global_shifts(grid: Grid) -> Shifts:
    return Shifts(im1=grid.im1, ip1=grid.ip1, jm1=grid.jm1,
                  jp1v=lambda a: grid.jp1(a, 'v', True),
                  jp1q=lambda a: grid.jp1(a, 'q'))


def local_shifts() -> Shifts:
    """Shifts on a halo-widened block: slice and zero pad, never a roll
    (the ghost rings take the edge's garbage; the caller's margin
    schedule keeps it out of the block)."""
    def sh(off, axis):
        return lambda a: stencil._shift(a, axis, off, False)
    return Shifts(im1=sh(-1, -1), ip1=sh(1, -1), jm1=sh(-1, -2),
                  jp1v=sh(1, -2), jp1q=sh(1, -2))


def substep_weights(lstep: int):
    """Per-substep PGF time-interpolation weights (mod_barotp.F90:328-358):
    block 1 ramps the old level out, blocks 2-3 ramp the new level in,
    blocks 4-5 use the new level only.  Returns weights(nb, lll) ->
    (wo, wm, wn)."""
    half = lstep // 2

    def weights(nb, lll):
        if nb == 1:
            woa, wob = -1. / lstep, .5 + .5 / lstep
            wna, wnb = 0., 0.
        elif nb in (2, 3):
            woa, wob = 0., 0.
            wna, wnb = 1. / lstep, -(1 + half - .5) / lstep
        else:
            woa, wob = 0., 0.
            wna, wnb = 0., 1.
        wo = woa * lll + wob
        wn = wna * lll + wnb
        wm = 1. - wo - wn
        return wo, wm, wn

    return weights


def make_substep(fld, sh: Shifts, lstep: int, dlt, par: BarotpParams):
    """The per-substep update over a field bundle (mod_barotp.F90:360-838).
    The returned function updates the working-level tensors of its carry
    in place."""
    if par.mommth not in ('enscon', 'enecon', 'enedis'):
        raise ValueError(f'barotp mommth={par.mommth!r}')
    im1, ip1, jm1, jp1v, jp1q = sh
    weights = substep_weights(lstep)

    def pgf_terms_u(wo, wm, wn, pb_nl):
        pbw = im1(pb_nl)
        return (wo * (fld['pgfxm_o']
                      - (fld['xixp_o'] * pb_nl - fld['xixm_o'] * pbw))
                + wm * (fld['pgfxm_m']
                        - (fld['xixp_m'] * pb_nl - fld['xixm_m'] * pbw))
                + wn * (fld['pgfxm_n']
                        - (fld['xixp_n'] * pb_nl - fld['xixm_n'] * pbw))) \
            * fld['scuxi']

    def pgf_terms_v(wo, wm, wn, pb_nl):
        pbs = jm1(pb_nl)
        return (wo * (fld['pgfym_o']
                      - (fld['xiyp_o'] * pb_nl - fld['xiym_o'] * pbs))
                + wm * (fld['pgfym_m']
                        - (fld['xiyp_m'] * pb_nl - fld['xiym_m'] * pbs))
                + wn * (fld['pgfym_n']
                        - (fld['xiyp_n'] * pb_nl - fld['xiym_n'] * pbs))) \
            * fld['scvyi']

    # q terms of the momentum equations (mod_barotp.F90:428-435 enscon,
    # :471-480 enecon; enedis takes the enecon form)
    def coriolis_u(vb_src, pvt_w):
        vsx = vb_src * fld['scvxi']
        if par.mommth == 'enscon':
            return (vsx + jp1v(vsx) + im1(vsx) + im1(jp1v(vsx))) \
                * (pvt_w + jp1q(pvt_w)) * .125
        return .25 * ((vsx + im1(vsx)) * pvt_w
                      + (jp1v(vsx) + im1(jp1v(vsx))) * jp1q(pvt_w))

    def coriolis_v(ub_src, pvt_w):
        usy = ub_src * fld['scuyi']
        if par.mommth == 'enscon':
            return -(usy + ip1(usy) + jm1(usy) + ip1(jm1(usy))) \
                * (pvt_w + ip1(pvt_w)) * .125
        return -.25 * ((usy + jm1(usy)) * pvt_w
                       + (ip1(usy) + ip1(jm1(usy))) * ip1(pvt_w))

    def continuity(pb_ml, pb_nl, ubf_ml, vbf_ml):
        return ((1. - wbaro) * pb_ml + wbaro * pb_nl
                - (1. + wbaro) * dlt
                * (ip1(ubf_ml) - ubf_ml + jp1v(vbf_ml) - vbf_ml)
                * fld['scp2i']) * fld['ip']

    def u_update(ubf_ml, ubf_nl, pb_nl, utndcy):
        new = ((1. - wbaro) * ubf_ml + wbaro * ubf_nl
               + (1. + wbaro) * dlt
               * ((utndcy + fld['utotn']) * fld['scuy']
                  * torch.minimum(im1(pb_nl), pb_nl)
                  - fld['uglue'] * ubf_ml))
        return torch.clamp(new, -fld['uminb'], fld['umaxb']) * fld['iu']

    def v_update(vbf_ml, vbf_nl, pb_nl, vtndcy):
        new = ((1. - wbaro) * vbf_ml + wbaro * vbf_nl
               + (1. + wbaro) * dlt
               * ((vtndcy + fld['vtotn']) * fld['scvx']
                  * torch.minimum(jm1(pb_nl), pb_nl)
                  - fld['vglue'] * vbf_ml))
        return torch.clamp(new, -fld['vminb'], fld['vmaxb']) * fld['iv']

    def substep(nb, carry, lll):
        pb_t, ubflx_t, vbflx_t, us_t, vs_t, uc_t, vc_t = carry
        ml = 0 if lll % 2 == 1 else 1
        nl = 1 - ml
        wo, wm, wn = weights(nb, lll)
        pvt_w = (wo * fld['pvtrop_o'] + wm * fld['pvtrop_m']
                 + wn * fld['pvtrop_n'])

        pb_ml, pb_nl = pb_t[ml], pb_t[nl]
        ubf_ml, ubf_nl = ubflx_t[ml], ubflx_t[nl]
        vbf_ml, vbf_nl = vbflx_t[ml], vbflx_t[nl]

        pb_new = continuity(pb_ml, pb_nl, ubf_ml, vbf_ml)

        us = us_t - wbaro * ubf_nl + (1. + wbaro) * ubf_ml
        vs = vs_t - wbaro * vbf_nl + (1. + wbaro) * vbf_ml
        if lll % 2 == 1:
            # u first with v(ml); then v with the new u
            # (mod_barotp.F90:399-615)
            qu = coriolis_u(vbf_ml, pvt_w)
            ubf_new = u_update(ubf_ml, ubf_nl, pb_new,
                               qu + pgf_terms_u(wo, wm, wn, pb_new))
            qv = coriolis_v(ubf_new, pvt_w)
            vbf_new = v_update(vbf_ml, vbf_nl, pb_new,
                               qv + pgf_terms_v(wo, wm, wn, pb_new))
        else:
            # v first with u(ml); then u with the new v
            # (mod_barotp.F90:617-838)
            qv = coriolis_v(ubf_ml, pvt_w)
            vbf_new = v_update(vbf_ml, vbf_nl, pb_new,
                               qv + pgf_terms_v(wo, wm, wn, pb_new))
            qu = coriolis_u(vbf_new, pvt_w)
            ubf_new = u_update(ubf_ml, ubf_nl, pb_new,
                               qu + pgf_terms_u(wo, wm, wn, pb_new))

        pb_t[nl] = pb_new
        ubflx_t[nl] = ubf_new
        vbflx_t[nl] = vbf_new
        return (pb_t, ubflx_t, vbflx_t, us, vs, uc_t + qu, vc_t + qv)

    return substep


def block_loop(nb, substep, half, carry):
    """One weight block: `half` substeps."""
    lll0 = 1 + (nb - 1) * half
    for lll in range(lll0, lll0 + half):
        carry = substep(nb, carry, lll)
    return carry


def run_blocks(fld, sh: Shifts, s_ubflxs, s_vbflxs, s_ubflxs_p, s_vbflxs_p,
               m: int, n: int, lstep: int, dlt, par: BarotpParams,
               block_runner=None):
    """The five weight blocks (mod_barotp.F90:328-986).  Returns
    (out, sums); the inputs are not modified.

    `block_runner(nb, substep, half, carry) -> carry`, when given, runs
    each block in place of `block_loop` (barotp_shmap's loop with an
    exchange every few substeps)."""
    ip, iu, iv = fld['ip'], fld['iu'], fld['iv']
    im1, jm1 = sh.im1, sh.jm1
    substep = make_substep(fld, sh, lstep, dlt, par)
    runner = block_runner or block_loop
    half = lstep // 2

    pb_t = fld['pb_t'].clone()
    ubflx_t = fld['ubflx_t'].clone()
    vbflx_t = fld['vbflx_t'].clone()

    z = torch.zeros_like(pb_t[0])
    ubflxs, vbflxs = s_ubflxs.clone(), s_vbflxs.clone()
    ubflxs_p, vbflxs_p = s_ubflxs_p.clone(), s_vbflxs_p.clone()
    ubcors_p = vbcors_p = z
    out = {}

    def level(pb):
        pbu = torch.minimum(pb, im1(pb)) * iu
        pbv = torch.minimum(pb, jm1(pb)) * iv
        return pb * ip, pbu, pbv

    for nb in (1, 2, 3, 4, 5):
        carry = runner(nb, substep, half,
                       (pb_t, ubflx_t, vbflx_t, z, z, z, z))
        pb_t, ubflx_t, vbflx_t, us_t, vs_t, uc_t, vc_t = carry
        ml_end = (nb * half) % 2   # slot holding 'ml' after the block

        if nb in (1, 3):
            # state at baroclinic mid level m (nb=1,
            # mod_barotp.F90:848-879) or new level n (nb=3, :913-945)
            tag = 'm' if nb == 1 else 'n'
            pb, pbu, pbv = level(pb_t[ml_end])
            out['pb_' + tag], out['pbu_' + tag], out['pbv_' + tag] = \
                pb, pbu, pbv
            out['ubflx_' + tag] = ubflx_t[ml_end] * iu
            out['vbflx_' + tag] = vbflx_t[ml_end] * iv
            out['ub_' + tag] = ubflx_t[ml_end] \
                / torch.clamp(pbu * fld['scuy'], min=epsilp) * iu
            out['vb_' + tag] = vbflx_t[ml_end] \
                / torch.clamp(pbv * fld['scvx'], min=epsilp) * iv
        if nb == 1:
            ubflxs[n] += us_t
            ubflxs[m] = ubflxs[2] + us_t
            vbflxs[n] += vs_t
            vbflxs[m] = vbflxs[2] + vs_t
        elif nb == 2:
            # checkpoint for the next step's restart of the barotropic
            # loop (mod_barotp.F90:880-912)
            out['pb_mn'] = pb_t * ip
            out['ubflx_mn'] = ubflx_t * iu
            out['vbflx_mn'] = vbflx_t * iv
            ubflxs[m] += us_t
            ubflxs[2] = us_t
            vbflxs[m] += vs_t
            vbflxs[2] = vs_t
            ubflxs_p[n] = us_t
            vbflxs_p[n] = vs_t
            ubcors_p = uc_t
            vbcors_p = vc_t
        elif nb == 3:
            ubflxs_p[m] = ubflxs[m] + us_t
            ubflxs_p[n] += us_t
            vbflxs_p[m] = vbflxs[m] + vs_t
            vbflxs_p[n] += vs_t
            ubcors_p = ubcors_p + uc_t
            vbcors_p = vbcors_p + vc_t
        else:
            # (mod_barotp.F90:946-986); nb=5 also predicts the bottom
            # pressure of the next step
            if nb == 5:
                out['pb_p'], out['pbu_p'], out['pbv_p'] = \
                    level(pb_t[ml_end])
            ubflxs_p[n] += us_t
            vbflxs_p[n] += vs_t
            ubcors_p = ubcors_p + uc_t
            vbcors_p = vbcors_p + vc_t

    sums = {'ubflxs': ubflxs, 'vbflxs': vbflxs,
            'ubflxs_p': ubflxs_p, 'vbflxs_p': vbflxs_p,
            'ubcors_p': ubcors_p, 'vbcors_p': vbcors_p}
    return out, sums


def finalize(s: State, m: int, n: int, out: dict, sums: dict) -> State:
    """Write the block outputs back into the State (the per-block stores
    of mod_barotp.F90:848-986)."""
    for name in ('pb', 'pbu', 'pbv', 'ub', 'vb', 'ubflx', 'vbflx'):
        a = getattr(s, name)
        a[m] = out[name + '_m']
        a[n] = out[name + '_n']
    s.pb_mn, s.ubflx_mn, s.vbflx_mn = \
        out['pb_mn'], out['ubflx_mn'], out['vbflx_mn']
    for name, val in sums.items():
        setattr(s, name, val)
    s.pb_p, s.pbu_p, s.pbv_p = out['pb_p'], out['pbu_p'], out['pbv_p']
    s.pvtrop[n] = out['pvtrop_n']
    return s


def barotp(grid: Grid, s: State, utotn, vtotn, m: int, n: int,
           lstep: int, dlt, par: BarotpParams) -> State:
    """Barotropic solve of one baroclinic step; updates `s` in place."""
    fld = _prologue(grid, s, utotn, vtotn, m, n, par)
    out, sums = run_blocks(fld, global_shifts(grid), s.ubflxs, s.vbflxs,
                           s.ubflxs_p, s.vbflxs_p, m, n, lstep, dlt, par)
    out['pvtrop_n'] = fld['pvtrop_n']
    return finalize(s, m, n, out, sums)
