"""The port's diagnostics (`io/dia.py`, `io/merdia.py`) against blom_tpu,
on CPU in f64.

- The registries: the same FIELD_REGISTRY ids with the same dims, the
  same MSC_REGISTRY ids with the same dependencies and tags, the same
  VALID_OPS.
- Every FIELD_REGISTRY id: `init_group` and `accumulate` over the two
  time levels of two steps of a small fuk95, from the same states, within
  1e-12 of blom_tpu's accumulators relative to their largest magnitude
  (the two mixed-layer depths within 1e-9, mxlayr's tolerance: their
  crossing walks interpolate in criterion values that round apart).  The
  ids of the bulk mixed layer and the TKE/GLS closure (tke, gls and their
  aliases, mtke*) run on the isopycnic fuk95 with the closure's two
  tracer slots; every other id on the ALE fuk95 with the ideal age
  (ntr 1, so that the tracer ids carry a tracer), seeded forcing, sea-ice
  and coupled fields.  The states come from the port's step, with the
  diffusion fields that fuk95 leaves zero seeded; both packages read the
  same numbers, and every id but the utility slots and psrf is non-zero.
- The min, max and sq ops on mixed-layer, isotherm and sst ids; every MSC
  id, derived from the accumulated means, within 1e-12.
- `write_netcdf` and `write_netcdf_compressed` of the same accumulators:
  the same dimensions, variables and values.
- `load_diaphy`, `unsupported_diaphy_keys`, `diafnm` and the alarm codes
  against blom_tpu's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from blom_tpu.core import grid as jgrid
from blom_tpu.core import modeltime as jmt
from blom_tpu.core import state as jstate
from blom_tpu.dynamics import diffusion_fields as jdff
from blom_tpu.io import dia as jdia
from blom_tpu.phys import forcing as jforcing
from blom_tpu.phys import seaice as jseaice
from blom_tpu.phys import swabs as jswabs
from blom_tpu_torch import convert
from blom_tpu_torch.core import modeltime as tmt
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.dynamics.difest import DifestParams
from blom_tpu_torch.io import dia as tdia
from blom_tpu_torch.phys.tke import init_tke_tracers
from tests.torch_shared import shared

SIZE = dict(itdm=24, jtdm=8, kdm=8)
ISOPYC_SIZE = dict(itdm=24, jtdm=8, kdm=10)
TOL = 1e-12
MLD_TOL = 1e-9
MLD_IDS = ('mldl82', 'mldb04')
ISOPYC_IDS = ('tke', 'gls', 'gls_psi', 'tkelvl', 'glslvl', 'gls_psilvl',
              'mtkeus', 'mtkeni', 'mtkebf', 'mtkers', 'mtkepe', 'mtkeke')
SEED = 11
# ids that are zero on these states: BLOM's scratch slots and the surface
# pressure (zero in fuk95)
ZERO_IDS = ('utilh2d', 'utillyr', 'utillvl', 'psrf')
# diffusion fields that fuk95's physics leaves zero (the submesoscale mass
# fluxes, the diapycnal diffusivity, the NIW and kinetic-energy terms of
# the mixed layer's TKE budget): (name, rows, mask, scale) of the seeded
# values that both packages read in their place, different in each step
# and time level, so that a wrong level or slot shows
ALE_SEEDS = (('umflsm', None, 'iu', 1e4), ('vmflsm', None, 'iv', 1e4),
             ('difdia', None, 'ip', 1e-4))
ISOPYC_SEEDS = (('mtke', (1, 5), 'ip', 1e-6),)
CESM_KEYS = ('lip', 'sop', 'eva', 'rnf', 'rfi', 'fmltfz', 'hmlt',
             'lamult', 'hstokes', 'ustokes', 'vstokes', 'slp', 'dfl',
             'hmat', 'idkedt')


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------ the states

def np_fields(obj):
    """{field: numpy array} of a dataclass of tensors or arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy().copy()
        elif not isinstance(v, (bool, int, str, type(None))):
            out[f.name] = np.asarray(v)
    return out


def grid_np(g):
    d = {k: getattr(g, k).numpy().copy() for k in TENSOR_FIELDS}
    d.update(periodic_i=g.periodic_i, periodic_j=g.periodic_j,
             arctic=g.arctic, kk=g.kk)
    return d


def jax_grid(d):
    return jgrid.Grid(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in d.items()})


def port_grid(d):
    return convert.grid_from_numpy(d, periodic_i=d['periodic_i'],
                                   periodic_j=d['periodic_j'], kk=d['kk'],
                                   arctic=d['arctic'])


def jax_obj(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _snapshot(m, seeds, nsteps=2):
    """The port model's states and diffusion fields after each of
    `nsteps` steps (numpy), with the time level each step wrote, the
    diffusion fields of `seeds` seeded, and the grid, forcing (seeded
    fields added), sea-ice, swabs and coupled fields that the diagnostics
    read."""
    s, dfl = m.state.clone(), m.dfl
    c = m.clock
    steps = []
    seed_rng = np.random.default_rng(SEED + 1)
    for i in range(nsteps):
        mm, n = (0, 1) if i % 2 == 0 else (1, 0)
        s, dfl = tstep.blom_step(m.grid, m.e, m.par, m.coeffs_i,
                                 m.coeffs_j, s, m.forcing, dfl, mm, n,
                                 c.delt1, m.swabs, m.bgc_forcing)
        c = c.step()
        dfl_np = np_fields(dfl)
        for name, rows, mask, scale in seeds:
            a = dfl_np[name]
            idx = slice(None) if rows is None else list(rows)
            a[idx] = (seed_rng.uniform(-scale, scale, a[idx].shape)
                      * getattr(m.grid, mask).numpy())
        steps.append((np_fields(s), dfl_np, n))
    rng = np.random.default_rng(SEED)
    shape = tuple(m.grid.shape)
    ip = m.grid.ip.numpy()
    forcing = np_fields(m.forcing)
    for k, scale in (('taux', .1), ('tauy', .1), ('surflx', 200.),
                     ('sswflx', 150.), ('salflx', 1e-4), ('brnflx', 1e-4),
                     ('surrlx', 2.), ('salrlx', 1e-4)):
        forcing[k] = rng.uniform(-scale, scale, shape) * ip
    si = {f.name: rng.uniform(0., 1., shape)
          for f in dataclasses.fields(jseaice.SeaiceState)}
    cesm = {k: rng.uniform(-1., 1., shape) for k in CESM_KEYS}
    return dict(grid=grid_np(m.grid), steps=steps, forcing=forcing, si=si,
                swabs=np_fields(m.swabs), cesm=cesm,
                tridx={'itriag': m.par.itriag, 'itrtke': m.par.itrtke,
                       'itrgls': m.par.itrgls})


def _build_states():
    m = tst.build_fuk95(use_idlage=True, device='cpu', **SIZE)
    m.par = m.par._replace(difest=DifestParams(egc=.85, egmndf=100.))
    ale = _snapshot(m, ALE_SEEDS)
    m = tst.build_fuk95(vcoord='isopyc_bulkml', device='cpu', **ISOPYC_SIZE)
    m.par = m.par._replace(difest=DifestParams(egc=.85, egmndf=100.),
                           itrtke=0, itrgls=1)
    m.state.trc = init_tke_tracers(torch.zeros(
        (2, 2) + m.state.dp.shape[1:], dtype=torch.float64), 0, 1)
    m.state.trcold = torch.zeros_like(m.state.trc[0])
    # wind and cooling, so that the bulk mixed layer's TKE budget works
    m.forcing = dataclasses.replace(m.forcing, taux=.1 * m.grid.iu,
                                    surflx=200. * m.grid.ip)
    return {'ale': ale, 'isopyc': _snapshot(m, ISOPYC_SEEDS)}


@pytest.fixture(scope='module')
def states(tmp_path_factory):
    return shared(tmp_path_factory, 'dia_states', _build_states)


class Both:
    """One snapshot as blom_tpu's and the port's objects."""

    def __init__(self, d):
        self.d = d
        self.jg, self.tg = jax_grid(d['grid']), port_grid(d['grid'])
        self.jf = jax_obj(jforcing.Forcing, d['forcing'])
        self.tf = convert.forcing_from_numpy(d['forcing'])
        self.jsi = jax_obj(jseaice.SeaiceState, d['si'])
        self.tsi = convert.seaice_from_numpy(d['si'])
        self.jsw = jax_obj(jswabs.SwabsFields, d['swabs'])
        self.tsw = convert.swabs_from_numpy(d['swabs'])
        self.jcesm = {k: jnp.asarray(v) for k, v in d['cesm'].items()}
        self.tcesm = {k: torch.tensor(v) for k, v in d['cesm'].items()}
        self.jsteps = [(jax_obj(jstate.State, s),
                        jax_obj(jdff.DiffusionFields, f), n)
                       for s, f, n in d['steps']]
        self.tsteps = [(convert.state_from_numpy(s),
                        convert.diffusion_fields_from_numpy(f), n)
                       for s, f, n in d['steps']]

    def groups(self, fields):
        """(blom_tpu's group, the port's group) over `fields`, each
        accumulated over the snapshot's steps."""
        out = []
        for dia, g, frc, si, sw, cesm, steps in (
                (jdia, self.jg, self.jf, self.jsi, self.jsw, self.jcesm,
                 self.jsteps),
                (tdia, self.tg, self.tf, self.tsi, self.tsw, self.tcesm,
                 self.tsteps)):
            kw = dict(si=si, swabs=sw, tridx=self.d['tridx'], cesm=cesm)
            grp = dia.init_group(g, steps[0][0], fields, forcing=frc,
                                 dfl=steps[0][1], **kw)
            for s, f, n in steps:
                grp = dia.accumulate(g, grp, s, n, frc, f, **kw)
            out.append(grp)
        return tuple(out)


_BOTH = {}


@pytest.fixture(scope='module')
def both(states):
    def get(kind):
        if kind not in _BOTH:
            _BOTH[kind] = Both(states[kind])
        return _BOTH[kind]
    return get


def rel_err(ref, out):
    a = np.asarray(ref)
    b = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not a.size:
        return 0.
    assert (np.isfinite(a) == np.isfinite(b)).all()
    fin = np.isfinite(a)
    if not fin.any():
        return 0.
    return float(np.abs(a[fin] - b[fin]).max()
                 / max(np.abs(a[fin]).max(), 1e-300))


# ------------------------------------------------------------ registries

def test_field_registry_matches_blom_tpu():
    assert list(tdia.FIELD_REGISTRY) == list(jdia.FIELD_REGISTRY)
    assert len(tdia.FIELD_REGISTRY) == 179
    assert ({k: d for k, (d, _) in tdia.FIELD_REGISTRY.items()}
            == {k: d for k, (d, _) in jdia.FIELD_REGISTRY.items()})


def test_msc_registry_matches_blom_tpu():
    assert list(tdia.MSC_REGISTRY) == list(jdia.MSC_REGISTRY)
    assert len(tdia.MSC_REGISTRY) == 23
    assert ({k: v[:2] for k, v in tdia.MSC_REGISTRY.items()}
            == {k: v[:2] for k, v in jdia.MSC_REGISTRY.items()})


def test_valid_ops_and_keys_match_blom_tpu():
    assert tdia.VALID_OPS == jdia.VALID_OPS
    for op in tdia.VALID_OPS:
        assert tdia._acc_key('mldl82', op) == jdia._acc_key('mldl82', op)


# ------------------------------------------------------------ every id

@pytest.mark.parametrize('name', list(jdia.FIELD_REGISTRY))
def test_field_id_matches_blom_tpu(both, name):
    b = both('isopyc' if name in ISOPYC_IDS else 'ale')
    jg, tg = b.groups([name])
    assert float(tg.nacc) == float(jg.nacc) == 2.
    ref = np.asarray(jg.acc[name])
    if name not in ZERO_IDS:
        assert np.abs(ref).max() > 0, f'{name} is zero on this state'
    tol = MLD_TOL if name in MLD_IDS else TOL
    assert rel_err(ref, tg.acc[name]) <= tol


OP_CASES = [('mldl82', 'min'), ('mldl82', 'max'), ('mldl82', 'sq'),
            ('mldb04', 'min'), ('mldb04', 'max'), ('t20d', 'min'),
            ('sst', 'sq'), ('sst', 'min'), ('sss', 'max')]


@pytest.mark.parametrize('name,op', OP_CASES)
def test_ops_match_blom_tpu(both, name, op):
    jg, tg = both('ale').groups([(name, op)])
    key = jdia._acc_key(name, op)
    tol = MLD_TOL if name in MLD_IDS else TOL
    assert rel_err(jg.acc[key], tg.acc[key]) <= tol


@pytest.mark.parametrize('name', list(jdia.MSC_REGISTRY))
def test_msc_id_matches_blom_tpu(both, name):
    from blom_tpu.io import merdia as jmer
    from blom_tpu_torch.io import merdia as tmer
    b = both('ale')
    jg, tg = b.groups([(name, 'msc')])
    lats = np.arange(-89.5, 90., 1.)
    jw = jmer.lat_bin_weights(b.jg.plat, jnp.asarray(lats))
    tw = tmer.lat_bin_weights(b.tg.plat, lats)
    q = 1. / float(jg.nacc)
    jm = {k: v * q for k, v in jg.acc.items()}
    tm = {k: v * q for k, v in tg.acc.items()}
    derive_j, derive_t = jdia.MSC_REGISTRY[name][2], tdia.MSC_REGISTRY[name][2]
    ref = np.asarray(derive_j(jm, b.jg, jw))
    if name not in ZERO_IDS:
        assert np.abs(ref).max() > 0
    # the transports sum fluxes of both signs: their error is relative to
    # the sum of the magnitudes they add
    scale = np.abs(np.asarray(derive_j(
        {k: jnp.abs(v) for k, v in jm.items()}, b.jg, jw))).max()
    out = derive_t(tm, b.tg, tw).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * max(scale, 1e-300)


# ------------------------------------------------------------ writers

def _all_fields():
    return ([n for n in jdia.FIELD_REGISTRY if n not in ISOPYC_IDS]
            + OP_CASES + [(n, 'msc') for n in jdia.MSC_REGISTRY])


def _as_jax_group(tg):
    return jdia.DiaGroup(nacc=jnp.asarray(tg.nacc.numpy()),
                         acc={k: jnp.asarray(v.numpy())
                              for k, v in tg.acc.items()},
                         fields=tg.fields)


def _read(path):
    with netcdf_file(str(path), 'r', mmap=False) as f:
        dims = dict(f.dimensions)
        return dims, {k: (v.dimensions, v[:].copy())
                      for k, v in f.variables.items()}


@pytest.mark.parametrize('writer', ['write_netcdf',
                                    'write_netcdf_compressed'])
def test_writers_match_blom_tpu(both, tmp_path, writer):
    """The port's writer and blom_tpu's, given the same accumulators
    (the port's, carried to blom_tpu), write the same file contents."""
    b = both('ale')
    fields = _all_fields()
    s0, f0, _ = b.tsteps[0]
    tg = tdia.init_group(b.tg, s0, fields, forcing=b.tf, dfl=f0, si=b.tsi,
                         swabs=b.tsw, tridx=b.d['tridx'], cesm=b.tcesm)
    for s, f, n in b.tsteps:
        tg = tdia.accumulate(b.tg, tg, s, n, b.tf, f, si=b.tsi, swabs=b.tsw,
                             tridx=b.d['tridx'], cesm=b.tcesm)
    getattr(tdia, writer)(str(tmp_path / 't.nc'), b.tg, tg, 1.25)
    getattr(jdia, writer)(str(tmp_path / 'j.nc'), b.jg, _as_jax_group(tg),
                          1.25)
    tdims, tvars = _read(tmp_path / 't.nc')
    jdims, jvars = _read(tmp_path / 'j.nc')
    assert tdims == jdims
    assert list(tvars) == list(jvars)
    assert len(tvars) > 150
    for k, (dims, a) in jvars.items():
        assert tvars[k][0] == dims, k
        assert tvars[k][1].dtype == a.dtype, k
        if k in jdia.MSC_REGISTRY and writer == 'write_netcdf':
            # derived by each package from the same means: sums in
            # another order, then written in f4
            assert np.abs(tvars[k][1] - a).max() <= 1e-6 * np.abs(a).max()
        else:
            np.testing.assert_array_equal(tvars[k][1], a, err_msg=k)


# ------------------------------------------------------------ DIAPHY

DIAPHY_DECK = """
&LIMITS
  NDAY1 = 0
  NDAY2 = 1
  RUNID = 'dg001'
  EXPCNF = 'fuk95'
  BACLIN = 180.
  BATROP = 6.
  RSTFRQ = 0
/
&DIAPHY
  GLB_FNAMETAG = 'hd','hm','hy'
  GLB_AVEPERIO = -240, 30, 365
  GLB_FILEFREQ = 1, 30
  GLB_COMPFLAG = 0, 1, 0
  GLB_NCFORMAT = 0, 0, 1
  H2D_SST = 1, 1, 0
  H2D_SSS = 1, 0, 1
  H2D_MLDL82 = 0, 1, 0
  H2D_MLDL82MX = 1, 0, 0
  H2D_MLDB04SQ = 0, 0, 1
  H2D_MAXBLD = 1, 0, 0
  H2D_TAUX = 1, 0, 0
  H2D_NOSUCHID = 1, 1, 1
  LYR_TEMP = 0, 1, 0
  LVL_SALN = 0, 1, 1
  MSC_TEMPGA = 1, 1, 0
  MSC_MMFLXD = 0, 0, 1
  MSC_NOSUCH = 1, 0, 0
/
"""


def _diaphy_groups():
    from blom_tpu_torch.core import namelist as tnml
    import tempfile
    import os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'limits')
        with open(path, 'w') as f:
            f.write(DIAPHY_DECK)
        return tnml.read_namelist_file(path)


def cfg_dicts(cfgs):
    """The groups' configs as dicts of the port's fields."""
    names = [f.name for f in dataclasses.fields(tdia.DiaGroupCfg)]
    return [{k: getattr(c, k) for k in names} for c in cfgs]


def test_load_diaphy_matches_blom_tpu():
    groups = _diaphy_groups()
    ref = jdia.load_diaphy(groups)
    out = tdia.load_diaphy(groups)
    assert all(not c.sharded_output for c in ref)
    assert cfg_dicts(out) == cfg_dicts(ref)
    assert len(out) == 3
    assert ('mldl82', 'max') in out[0].fields
    assert ('maxbld', 'max') in out[0].fields
    assert ('mldb04', 'sq') in out[2].fields
    assert ('mmflxd', 'msc') in out[2].fields
    assert (tdia.unsupported_diaphy_keys(groups)
            == jdia.unsupported_diaphy_keys(groups))
    assert tdia.load_diaphy({}) == jdia.load_diaphy({}) == []


def test_diafnm_and_steps_per_output_match_blom_tpu():
    for t in (0., 1.25, 365.5, 12345.678):
        assert (tdia.diafnm('run1', 'hd', t)
                == jdia.diafnm('run1', 'hd', t))
    for ave in (-240, -24, -1, 1, 5, 30, 365):
        for nspd in (24, 480):
            assert (tdia.DiaGroupCfg(aveperio=ave).steps_per_output(nspd)
                    == jdia.DiaGroupCfg(aveperio=ave).steps_per_output(nspd))


@pytest.mark.parametrize('aveperio', [-24, 1, 2, 30, 360, 365, 366])
def test_alarm_codes_match_blom_tpu(aveperio):
    """The alarms of each GLB_AVEPERIO code over ~50 model days that
    cross two month boundaries (and, from Dec 15, a year boundary)."""
    for ymd in (20000115, 20001215):
        fired = {}
        for name, mt, dia in (('j', jmt, jdia), ('t', tmt, tdia)):
            clock = mt.init_timevars('fuk95', 4320., 60., ymd, ymd)
            nspd = clock.nstep_in_day
            gc = dia.DiaGroupCfg(aveperio=aveperio)
            out = []
            for done in range(1, nspd * 50 + 1):
                clock = clock.step()
                if gc.alarm(clock, done, nspd):
                    out.append((done, clock.date.to_ymd()))
            fired[name] = out
        assert fired['t'] == fired['j']
        if aveperio == 30:
            assert len(fired['t']) == 2
