"""End-to-end CLI workflow test: the reference's de-facto validation
pipeline simCluster -> scatterCluster -> singlePopMcmc -> sampleMass /
sampleWDMass -> makeCMD (SURVEY.md §4.1, §3.3), driven through the same
tool surface, plus IO round-trips."""
import os

import numpy as np
import pytest

from base_tpu.io import phot as photio
from base_tpu.io import res as resio
from base_tpu.io.settings import load_settings
from base_tpu.tools.main import main


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


def _args(workdir, extra):
    return extra + [
        "--outputFileBase", str(workdir / "run"),
        "--seed", "5",
    ]


def test_settings_roundtrip(workdir):
    cfg = workdir / "base9.yaml"
    cfg.write_text(
        "cluster:\n  starting_logAge: 9.45\n  prior_Fe_H_sigma: 0.25\n"
        "simCluster:\n  nStars: 60\n  percentBinary: 0.2\n"
        "mcmc:\n  chains: 4\n"
    )
    s = load_settings(str(cfg), ["mcmc.runIter=400", "mcmc.sampler=mh"])
    assert s.cluster.starting_logAge == 9.45
    assert s.simCluster.nStars == 60
    assert s.mcmc.runIter == 400 and s.mcmc.sampler == "mh"
    with pytest.raises(KeyError):
        load_settings(None, ["mcmc.doesNotExist=1"])


def test_settings_field_box_and_sigma_model(workdir):
    """cluster.fieldMagRange accepts scalar, YAML list, and comma
    override (per-band field-density box); mcmc.sigmaModel is the
    quadrature-discretization noise floor."""
    cfg = workdir / "base9.yaml"
    cfg.write_text(
        "cluster:\n  fieldMagRange: [12.0, 13.0]\n"
        "mcmc:\n  sigmaModel: 0.01\n"
    )
    s = load_settings(str(cfg))
    assert s.mcmc.sigmaModel == 0.01
    assert list(s.cluster.field_mag_range_array(2)) == [12.0, 13.0]
    s2 = load_settings(str(cfg), ["cluster.fieldMagRange=11,12,13"])
    assert list(s2.cluster.field_mag_range_array(3)) == [11.0, 12.0, 13.0]
    s3 = load_settings(None)
    assert list(s3.cluster.field_mag_range_array(2)) == [20.0, 20.0]


def test_full_workflow(workdir):
    cfg = workdir / "base9.yaml"
    cfg.write_text(
        "cluster:\n"
        "  starting_logAge: 9.5\n  starting_Fe_H: -0.3\n"
        "  starting_distMod: 8.0\n  starting_Av: 0.15\n"
        "  prior_Fe_H: -0.3\n  prior_distMod: 8.0\n  prior_Av: 0.15\n"
        "simCluster:\n  nStars: 60\n  percentBinary: 0.0\n  percentDB: 0.1\n"
        "scatterCluster:\n  limitMag: 26.0\n"
        "mcmc:\n  chains: 4\n  runIter: 800\n  stage1Iter: 200\n"
        "  stage2IterMax: 200\n  sampler: mh\n  noBinaries: true\n"
    )
    base = ["--config", str(cfg)]

    # simulate
    main(_args(workdir, ["simulate"] + base))
    sim_file = str(workdir / "run.sim.phot")
    assert os.path.exists(sim_file)
    table = photio.read_phot(sim_file)
    assert table.n_stars == 60
    assert set(np.unique(table.stage)) <= {1, 3}

    # scatter
    main(_args(workdir, ["scatter"] + base + ["--photFile", sim_file]))
    phot_file = str(workdir / "run.phot")
    t2 = photio.read_phot(phot_file)
    assert t2.n_stars == 60
    assert (t2.sigmas[t2.sigmas > 0] > 0.005).all()
    # noise actually applied
    assert np.abs(t2.mags - table.mags).max() > 0

    # single-pop MH
    main(_args(workdir, ["single-pop"] + base + ["--photFile", phot_file]))
    chain = resio.read_res(str(workdir / "run.res"))
    assert chain.params.shape[0] == 800  # 200 per chain x 4 chains
    assert np.isfinite(chain.logpost).all()
    age = chain.params[:, 0]
    assert abs(age.mean() - 9.5) < 0.15

    # sample-mass: per-star layout + membership posterior round-trip
    main(_args(workdir, ["sample-mass"] + base + ["--photFile", phot_file]))
    from base_tpu.io.samples import read_star_samples

    ids, cols = read_star_samples(str(workdir / "run.massSamples"))
    n_ms = int((table.stage == 1).sum())
    assert len(ids) == n_ms
    assert set(cols) == {"mass", "massRatio"}
    assert cols["mass"].shape[1] == n_ms
    mids, mcols = read_star_samples(str(workdir / "run.membership"))
    assert mids == ids
    pm = mcols["pMember"]
    assert ((pm >= 0) & (pm <= 1)).all()

    # sample-wd-mass (only if the sim produced WDs)
    if (table.stage == 3).any():
        main(_args(workdir, ["sample-wd-mass"] + base + ["--photFile", phot_file]))
        assert os.path.exists(str(workdir / "run.wdMassSamples"))

    # make-cmd: stage column + upsampled MS sequence + WD cooling sequence
    main(_args(workdir, ["make-cmd"] + base))
    raw = np.loadtxt(str(workdir / "run.cmd"), skiprows=1, dtype=str)
    stages, vals = raw[:, 0], raw[:, 1:].astype(float)
    assert vals.shape[1] == 9  # mass + 8 bands
    ms = vals[stages == "MS"]
    assert (np.diff(ms[:, 0]) > 0).all()
    assert (stages == "WD").sum() > 0
    assert np.isfinite(vals).all()


def test_multipop_cli_smoke(workdir):
    """multi-pop end to end through the CLI (HMC ordered-transform path,
    host-chunked runner): simulate -> scatter -> multi-pop, sane .mp.res."""
    cfg = workdir / "mp.yaml"
    cfg.write_text(
        "cluster:\n"
        "  starting_logAge: 9.4\n  starting_Fe_H: -0.2\n"
        "  starting_distMod: 9.0\n  starting_Av: 0.1\n  starting_Y: 0.27\n"
        "  prior_Fe_H: -0.2\n  prior_distMod: 9.0\n  prior_Av: 0.1\n"
        "simCluster:\n  nStars: 48\n  percentBinary: 0.0\n"
        "scatterCluster:\n  limitMag: 26.0\n"
        "mcmc:\n  chains: 4\n  runIter: 256\n  warmup: 96\n  lMax: 8\n"
        "  noBinaries: true\n  nMassRatio: 4\n"
    )
    base = ["--config", str(cfg)]
    out = ["--outputFileBase", str(workdir / "mp"), "--seed", "11"]
    main(["simulate"] + base + out)
    main(["scatter"] + base + out
         + ["--photFile", str(workdir / "mp.sim.phot")])
    main(["multi-pop"] + base + out
         + ["--photFile", str(workdir / "mp.phot")])
    raw = np.loadtxt(str(workdir / "mp.mp.res"), skiprows=1)
    assert raw.shape[1] == 14  # 12 params + logPost + chain
    assert np.isfinite(raw).all()
    ya, yb = raw[:, 9], raw[:, 10]
    assert (yb > ya).all()          # ordered transform holds
    lam = raw[:, 11]
    assert ((lam > 0) & (lam < 1)).all()


def test_multipop_inverted_start_errors(workdir):
    """startY_A >= startY_B must exit with a clear error, not feed
    dY <= 0 into the ordered transform's inverse (NaN inits) —
    ADVICE r4."""
    cfg = workdir / "mpbad.yaml"
    cfg.write_text(
        "simCluster:\n  nStars: 16\n"
        "multiPop:\n  startY_A: 0.33\n  startY_B: 0.25\n"
    )
    base = ["--config", str(cfg)]
    out = ["--outputFileBase", str(workdir / "mpb"), "--seed", "3"]
    main(["simulate"] + base + out)
    main(["scatter"] + base + out
         + ["--photFile", str(workdir / "mpb.sim.phot")])
    with pytest.raises(SystemExit):
        main(["multi-pop"] + base + out
             + ["--photFile", str(workdir / "mpb.phot")])


def test_phot_roundtrip(workdir, rng):
    t = photio.from_simulation(
        ids=None, bands=("U", "B", "V"),
        mags=rng.normal(15, 2, (7, 3)),
        sigmas=np.abs(rng.normal(0.02, 0.01, (7, 3))),
        cm_prior=0.9,
    )
    t.sigmas[2, 1] = -9.0
    p = str(workdir / "round.phot")
    photio.write_phot(p, t)
    t2 = photio.read_phot(p)
    np.testing.assert_allclose(t2.mags, t.mags, atol=1e-5)
    np.testing.assert_allclose(t2.sigmas, t.sigmas, atol=1e-5)
    assert t2.bands == ("U", "B", "V")
    assert (t2.stage == t.stage).all()


def test_res_roundtrip(workdir, rng):
    samples = rng.normal(size=(50, 3, 9)).astype(np.float32)
    lp = rng.normal(size=(50, 3)).astype(np.float32)
    p = str(workdir / "round.res")
    resio.write_res(p, samples, lp)
    t = resio.read_res(p)
    assert t.params.shape == (150, 9)
    np.testing.assert_allclose(
        t.params.reshape(50, 3, 9), samples, atol=1e-5
    )
    assert t.chain is not None and set(t.chain) == {0, 1, 2}


def test_sqlite_store_roundtrip(workdir, rng):
    from base_tpu.io.sqlite_store import read_res_sqlite, write_res_sqlite

    samples = rng.normal(size=(20, 3, 9)).astype(np.float32)
    lp = rng.normal(size=(20, 3)).astype(np.float32)
    p = str(workdir / "chain.sqlite")
    write_res_sqlite(p, samples, lp, meta={"sampler": "hmc", "seed": 7})
    params, logpost, chain, meta = read_res_sqlite(p)
    assert params.shape == (60, 9)
    np.testing.assert_allclose(
        params.reshape(20, 3, 9), samples, atol=1e-6
    )
    np.testing.assert_allclose(logpost.reshape(20, 3), lp, atol=1e-6)
    assert meta["sampler"] == "hmc" and meta["seed"] == "7"


def test_removed_use_pallas_key_is_rejected():
    """mcmc.usePallas is gone (the marginal's implementation follows the
    device); an old config naming it fails loudly (docs/MIGRATION.md)."""
    with pytest.raises(KeyError):
        load_settings(None, ["mcmc.usePallas=true"])


def test_multipop_settings_section():
    """multiPop section keys (reference-style YA/YB/lambda starts &
    steps, SURVEY.md C12) load and override."""
    s = load_settings(None, [
        "multiPop.startY_A=0.25", "multiPop.startY_B=0.31",
        "multiPop.startLambda=0.4", "multiPop.stepLambda=0.02",
    ])
    assert s.multiPop.startY_A == 0.25
    assert s.multiPop.startY_B == 0.31
    assert s.multiPop.startLambda == 0.4
    assert s.multiPop.stepLambda == 0.02
    # defaults: NaN = derive from cluster Y
    d = load_settings(None, [])
    assert np.isnan(d.multiPop.startY_A)


def test_sqlite_store_cli_wiring(workdir):
    """--store sqlite on single-pop writes <base>.db through
    io.sqlite_store alongside the .res (VERDICT r3 #9)."""
    cfg = workdir / "sq.yaml"
    cfg.write_text(
        "cluster:\n  starting_logAge: 9.5\n"
        "simCluster:\n  nStars: 24\n  percentBinary: 0.0\n"
        "mcmc:\n  chains: 2\n  runIter: 64\n  stage1Iter: 50\n"
        "  stage2IterMax: 50\n  sampler: mh\n  noBinaries: true\n"
    )
    base = ["--config", str(cfg)]
    out = ["--outputFileBase", str(workdir / "sq"), "--seed", "3"]
    main(["simulate"] + base + out)
    main(["scatter"] + base + out
         + ["--photFile", str(workdir / "sq.sim.phot")])
    main(["single-pop"] + base + out + ["--store", "sqlite",
         "--photFile", str(workdir / "sq.phot")])
    from base_tpu.io.sqlite_store import read_res_sqlite

    params, logpost, chain, meta = read_res_sqlite(str(workdir / "sq.db"))
    res = resio.read_res(str(workdir / "sq.res"))
    assert params.shape[0] == res.params.shape[0] == 64
    np.testing.assert_allclose(params[:, :6], res.params[:, :6], atol=1e-5)
    assert meta["tool"] == "single-pop"
    assert set(np.unique(chain)) == {0, 1}
