"""The port's fixed-order sums, BGC inventory, CFCs and iHAMOCC extensions
(blom_tpu_torch.parallel.repsum, bgc.inventory, bgc.cfc, bgc.extensions)
against blom_tpu's, on CPU in f64.

Each function from the same inputs, made from a seed with numpy (the
columns of tests/test_bgc.py's `_column`, widened with the extension
slots as tests/test_bgc.py widens them), blom_tpu run op by op
(`jax.disable_jit()`).  The strip sums are sequences of f64 adds in a
fixed order and must agree exactly; every other output field within
rtol = atol = 1e-12 of its largest value, as tests/test_torch_bgc.py
holds the base chain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.bgc import cfc as jcfc
from blom_tpu.bgc import extensions as jext
from blom_tpu.bgc import inventory as jinv
from blom_tpu.bgc import sediment as jsed
from blom_tpu.bgc.params import (NBGC, BgcParams as JBgcParams,
                                 make_tracer_index as jmake_ti)
from blom_tpu.parallel import repsum as jrep
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import cfc as tcfc
from blom_tpu_torch.bgc import extensions as text
from blom_tpu_torch.bgc import inventory as tinv
from blom_tpu_torch.bgc.params import (BgcParams, BgcTracers as T,
                                       make_tracer_index)
from blom_tpu_torch.parallel import repsum as trep
from tests.test_bgc import _column
from tests.test_torch_bgc import TOL, _close, _close_all, _t

DTB = .5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _exact(ref, port):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ------------------------------------------------------------- repsum

@pytest.mark.parametrize('shape', [(5, 18), (7, 23), (1, 4), (360 // 12,
                                                               384 // 8)])
@pytest.mark.parametrize('masked', [False, True])
def test_repsum_2d_matches_blom_tpu_exactly(shape, masked):
    """Strips that end inside the row (23, 4) and exactly at its end
    (18, 48); with and without a mask."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    a = rng.normal(0., 1e3, shape) * 10. ** rng.integers(-6, 6, shape)
    mask = (rng.random(shape) > .3) * 1. if masked else None
    ref = jrep.repsum_2d(jnp.asarray(a), None if mask is None
                         else jnp.asarray(mask))
    _exact(ref, trep.repsum_2d(_t(a), None if mask is None else _t(mask)))


@pytest.mark.parametrize('strip', [jrep.STRIP, 4])
def test_repsum_3d_and_dispatch_match_blom_tpu_exactly(strip):
    rng = np.random.default_rng(strip)
    a = rng.normal(0., 1., (6, 5, 22))
    mask = (rng.random((5, 22)) > .2) * 1.
    _exact(jrep.repsum_3d(jnp.asarray(a), jnp.asarray(mask), strip),
           trep.repsum_3d(_t(a), _t(mask), strip))
    _exact(jrep.repsum(jnp.asarray(a), strip=strip),
           trep.repsum(_t(a), strip=strip))
    _exact(jrep.repsum(jnp.asarray(a[0]), strip=strip),
           trep.repsum(_t(a[0]), strip=strip))
    with pytest.raises(ValueError, match='rank'):
        trep.repsum(_t(a[None]))


def test_repsum_batches_as_vmap():
    """A leading batch dimension sums each member as blom_tpu's
    jax.vmap(repsum_3d) and jax.vmap(repsum_2d) do, bit for bit."""
    rng = np.random.default_rng(8)
    a = rng.normal(0., 1., (4, 3, 6, 20))
    _exact(jax.vmap(jrep.repsum_3d)(jnp.asarray(a)),
           trep.repsum_3d(_t(a)))
    _exact(jax.vmap(jrep.repsum_2d)(jnp.asarray(a[:, 0])),
           trep.repsum_2d(_t(a[:, 0])))


# ----------------------------------------------------------- inventory

def _ext_column(ti, seed=3, hypoxic=False):
    """tests/test_bgc.py's column widened with ti's extension slots, each
    filled from a seed; with `hypoxic` the deep half nearly anoxic."""
    oc, dz, temp, saln = (np.array(a) for a in _column())
    rng = np.random.default_rng(seed)
    extra = rng.uniform(0., 1.e-6, (ti.ntotal - NBGC,) + oc.shape[1:])
    oc = np.concatenate([oc, extra])
    if hypoxic:
        oc[T.oxygen, 10:] = 1.e-9
    return oc, dz, temp, saln


def _sed_state(shape, seed=5):
    rng = np.random.default_rng(seed)
    sed = jsed.init_sediment(shape)
    fields = {f.name: np.asarray(getattr(sed, f.name)) *
              rng.uniform(.5, 1.5, np.shape(getattr(sed, f.name)))
              for f in dataclasses.fields(sed)}
    fields['sedlay'] = rng.uniform(0., 1e-2, fields['sedlay'].shape)
    fields['burial'] = rng.uniform(0., 1e-3, fields['burial'].shape)
    return fields


@pytest.mark.parametrize('case', ['base', 'extn', 'bromo_sed_atm'])
def test_inventory_bgc_matches_blom_tpu(case):
    kw = {'extn': dict(use_extncycle=True),
          'bromo_sed_atm': dict(use_bromo=True, use_ciso=True)}.get(case)
    ti_j = jmake_ti(**kw) if kw else None
    ti_t = make_tracer_index(**kw) if kw else None
    if kw:
        oc, dz, temp, saln = _ext_column(ti_t)
    else:
        oc, dz, temp, saln = (np.array(a) for a in _column())
    oc[T.oxygen, 15:, 1] = 1.e-5          # an ODZ
    rng = np.random.default_rng(7)
    area = rng.uniform(1e8, 4e8, dz.shape[1:])
    om = (rng.random(dz.shape[1:]) > .2) * 1.
    dz[:, om == 0] = 0.
    extra_j, extra_t = {}, {}
    if case == 'bromo_sed_atm':
        sed = _sed_state(dz.shape[1:])
        extra_j = dict(sed=jsed.SedState(**{k: jnp.asarray(v)
                                            for k, v in sed.items()}),
                       atm_co2_ppm=284.7)
        extra_t = dict(sed=convert.sed_state_from_numpy(sed),
                       atm_co2_ppm=284.7)
    ref = jinv.inventory_bgc(*map(jnp.asarray, (oc, dz, area, om)),
                             JBgcParams(), ti=ti_j, **extra_j)
    port = tinv.inventory_bgc(*map(_t, (oc, dz, area, om)), BgcParams(),
                              ti=ti_t, **extra_t)
    _close_all(ref, port)
    assert float(port['odz_volume']) > 0.
    d_ref = jinv.inventory_deltas(ref, dict(ref, totalcarbon=ref[
        'totalcarbon'] * 1.5, totalphos=-ref['totalphos']))
    d_port = tinv.inventory_deltas(port, dict(port, totalcarbon=port[
        'totalcarbon'] * 1.5, totalphos=-port['totalphos']))
    assert d_port.keys() == d_ref.keys()
    for k in d_ref:
        assert d_port[k] == pytest.approx(d_ref[k], rel=TOL, abs=TOL), k


# ---------------------------------------------------------------- CFC

def test_cfc_coefficients_match_blom_tpu():
    t = np.linspace(-2., 35., 75)
    s = np.linspace(30., 38., 75)
    _close_all(jcfc.schmidt_cfc(jnp.asarray(t)), tcfc.schmidt_cfc(_t(t)))
    _close_all(jcfc.solubility_cfc(*map(jnp.asarray, (t, s))),
               tcfc.solubility_cfc(_t(t), _t(s)))
    plat = np.linspace(-40., 40., 75)
    _close(jcfc.hemisphere_blend(jnp.asarray(plat), 270., 260.),
           tcfc.hemisphere_blend(_t(plat), 270., 260.))
    assert tcfc.CfcAtm()._asdict() == jcfc.CfcAtm()._asdict()


def test_cfc_exchange_matches_blom_tpu():
    rng = np.random.default_rng(13)
    kk, jj, ii = 5, 4, 6
    H = (jj, ii)
    gases = [rng.uniform(0., 1e-12, (kk, jj, ii)) for _ in range(3)]
    surf = (rng.uniform(-3., 42., H), rng.uniform(3., 41., H),
            np.broadcast_to(np.linspace(-60., 60., jj)[:, None], H).copy(),
            rng.uniform(0., 15., H), rng.uniform(0., .6, H),
            rng.uniform(99000., 103000., H), rng.uniform(0., 50., H))
    wet0 = rng.random(H) > .2
    atm = dict(cfc11_nh=270., cfc11_sh=260., cfc12_nh=520., cfc12_sh=505.,
               sf6_nh=3., sf6_sh=2.8)
    with jax.disable_jit():
        ref = jcfc.cfc_exchange(*map(jnp.asarray, gases + list(surf)),
                                jnp.asarray(wet0), jcfc.CfcAtm(**atm),
                                1800.)
    port = tcfc.cfc_exchange(*map(_t, gases + list(surf)), _t(wet0),
                             tcfc.CfcAtm(**atm), 1800.)
    for r, p in zip(ref[:3], port[:3]):
        _close(r, p)
    _close_all(ref[3], port[3])


# -------------------------------------------------------- extensions

def _ep_pair():
    return jext.ExtNParams(), text.ExtNParams()


def test_extension_params_match_blom_tpu():
    je, te = _ep_pair()
    assert te._asdict() == je._asdict()
    for name in ('mufn2o', 'bn2o', 'bkanh4anmx', 'rnh4dnra'):
        assert getattr(te, name) == getattr(je, name), name
    assert text.BromoParams()._asdict() == jext.BromoParams()._asdict()


EXTN = ('nitrification', 'denit_no3_to_no2', 'anammox', 'denit_dnra',
        'extn_watercol')


@pytest.mark.parametrize('hypoxic', [False, True])
@pytest.mark.parametrize('name', EXTN)
def test_extn_process_matches_blom_tpu(name, hypoxic):
    """Each process of the extended N cycle, oxic and with the deep half
    nearly anoxic (where anammox runs), with hot water
    above 40 C in a few cells (BLOM's temperature merge) and a dry
    cell."""
    jti, tti = jmake_ti(use_extncycle=True), make_tracer_index(
        use_extncycle=True)
    oc, dz, temp, saln = _ext_column(tti, hypoxic=hypoxic)
    temp[0, 0, :2] = 41.
    wet = np.ones(dz.shape, bool)
    wet[3, 1, 2] = False
    je, te = _ep_pair()
    args_j = (jnp.asarray(oc), jti, jnp.asarray(temp), jnp.asarray(wet),
              DTB, JBgcParams())
    args_t = (_t(oc), tti, _t(temp), _t(wet), DTB, BgcParams())
    with jax.disable_jit():
        ref = getattr(jext, name)(*args_j, je)
    port = getattr(text, name)(*args_t, te)
    _close(ref[0], port[0], name='oc')
    _close_all(ref[1], port[1])
    if hypoxic or name != 'anammox':     # anammox needs low oxygen
        assert float((port[0] - _t(oc)).abs().max()) > 0.


def test_bromoform_matches_blom_tpu():
    rng = np.random.default_rng(17)
    kk, jj, ii = 5, 4, 6
    H, K3 = (jj, ii), (kk, jj, ii)
    bromo = rng.uniform(0., 1e-11, K3)
    wet = rng.random(K3) > .1
    swa = rng.uniform(0., 200., H)
    swa[0, 0] = 0.
    args = (bromo, rng.uniform(0., 1e-7, K3), rng.uniform(0., 1e-4, K3),
            rng.uniform(0., 300., H), swa, rng.uniform(0., 1., K3))
    bp_j, bp_t = jext.BromoParams(), text.BromoParams()
    with jax.disable_jit():
        ref = jext.bromo_ocprod(*map(jnp.asarray, args), 1.e-5, DTB, bp_j,
                                jnp.asarray(wet))
    port = text.bromo_ocprod(*map(_t, args), 1.e-5, DTB, bp_t, _t(wet))
    _close(ref[0], port[0])
    _close_all(ref[1], port[1])

    deep = (bromo, rng.uniform(271., 305., K3), rng.uniform(1e-15, 1e-13, K3),
            rng.uniform(1e-9, 1e-7, K3))
    _close(jext.bromo_deep_decay(*map(jnp.asarray, deep), 86400.,
                                 jnp.asarray(wet)),
           text.bromo_deep_decay(*map(_t, deep), 86400., _t(wet)))

    surf = (bromo[0], rng.uniform(-2., 30., H), rng.uniform(0., .6, H),
            rng.uniform(0., 15., H), rng.uniform(99000., 103000., H),
            rng.uniform(0., 50., H))
    ref = jext.bromo_surface_flux(*map(jnp.asarray, surf), 3600., bp_j,
                                  jnp.asarray(wet[0]))
    port = text.bromo_surface_flux(*map(_t, surf), 3600., bp_t, _t(wet[0]))
    _close_all(ref, port)


def test_natdic_matches_blom_tpu():
    """natdic_bio_mirror, and carchm_nat on a column whose natural
    tracers differ from the base ones."""
    jti, tti = jmake_ti(use_natdic=True), make_tracer_index(use_natdic=True)
    oc, dz, temp, saln = (np.array(a) for a in _column(kk=6))
    rng = np.random.default_rng(19)
    ext = np.zeros((tti.ntotal - NBGC,) + oc.shape[1:])
    oc = np.concatenate([oc, ext])
    oc[tti.natsco212] = oc[T.sco212] * rng.uniform(.97, 1., oc.shape[1:])
    oc[tti.natalkali] = oc[T.alkali]
    oc[tti.natcalc] = oc[T.calc] * 3.
    oc[tti.nathi] = oc[T.hi]
    post = oc.copy()
    post[T.sco212] += rng.uniform(-1e-6, 1e-6, oc.shape[1:])
    post[T.calc] += 2.e-7
    _close(jext.natdic_bio_mirror(jnp.asarray(oc), jnp.asarray(post), jti),
           text.natdic_bio_mirror(_t(oc), _t(post), tti))

    shp = dz.shape
    lyr = np.ones(shp, bool)
    lyr[2, 1, 1] = False
    rho = 1.02 + .01 * rng.random(shp)
    ptiestu = np.cumsum(dz, axis=0) - 0.5 * dz
    surf = (rng.uniform(0., 12., shp[1:]), rng.uniform(99000., 103000.,
                                                       shp[1:]),
            rng.uniform(0., .3, shp[1:]))
    args = (oc, temp, saln, rho, dz, ptiestu, lyr) + surf
    with jax.disable_jit():
        ref = jext.carchm_nat(jnp.asarray(oc), jti,
                              *map(jnp.asarray, args[1:]), 3600.,
                              JBgcParams(), atm_co2_nat=280.)
    port = text.carchm_nat(_t(oc), tti, *map(_t, args[1:]), 3600.,
                           BgcParams(), atm_co2_nat=280.)
    _close(ref[0], port[0], name='oc')
    _close_all(ref[1], port[1])


def test_shelfsea_residence_time_matches_blom_tpu():
    rng = np.random.default_rng(23)
    age = rng.uniform(0., 1., (3, 4, 5))
    shelf = rng.random((4, 5)) > .5
    wet = rng.random((3, 4, 5)) > .2
    _close(jext.shelfsea_residence_time(*map(jnp.asarray,
                                             (age, shelf, wet)), .7),
           text.shelfsea_residence_time(_t(age), _t(shelf), _t(wet), .7))
