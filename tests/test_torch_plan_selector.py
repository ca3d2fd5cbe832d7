"""The port's plan selector (``repro_torch.autotune.plan_selector``) against
the reference's (``repro.autotune.plan_selector``), on the CPU.

The reference's three selector tests (``tests/test_autotune_hlo.py``),
ported; then parity on the same synthetic dry-run records: the same
``build_dataset`` features and labels, and the same ``recommend`` for
every arch × shape × production mesh, learned and by the analytic
fallback, with the reference's capacity (v5e's 16e9 bytes) passed in; and
``workload_features`` of all ten archs × four shapes equal to the
reference's, exactly, in float64.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.autotune import PlanSelector as RefSelector  # noqa: E402
from repro.autotune import workload_features as ref_features  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.config import SHAPES as REF_SHAPES  # noqa: E402
from repro_torch.autotune import (CANDIDATE_PLANS, PlanSelector,  # noqa: E402
                                  plan_label, workload_features)
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.distributed.sharding import ExecutionPlan  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402

#: the reference's HBM capacity in ``_score`` and ``_analytic_rule``
REF_HBM = 16e9
MESHES = (("pod16x16", 16, 16), ("pod2x16x16", 32, 16))


def _fake_record(arch, shape, mesh, plan_name, dom, resident=8e9):
    plan = CANDIDATE_PLANS[plan_name]
    return dict(arch=arch, shape=shape, mesh=mesh, status="ok",
                plan=dict(plan.__dict__),
                resident_bytes=resident,
                roofline=dict(compute_s=dom, memory_s=dom * 0.5,
                              collective_s=dom * 0.2))


def test_plan_selector_learns_from_artifacts():
    arts = []
    archs = ["llama3.2-1b", "qwen3-1.7b", "codeqwen1.5-7b", "starcoder2-7b",
             "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
             "jamba-v0.1-52b", "musicgen-large"]
    # synthetic ground truth: big models prefer fsdp, small prefer baseline
    for arch in archs:
        big = get_config(arch).param_count() > 5e9
        for shape in ["train_4k", "prefill_32k"]:
            better, worse = (("fsdp", "baseline") if big
                             else ("baseline", "fsdp"))
            arts.append(_fake_record(arch, shape, "pod16x16", better, 1.0))
            arts.append(_fake_record(arch, shape, "pod16x16", worse, 2.0))
    sel = PlanSelector(min_samples=8).fit(artifacts=arts)
    assert sel.model is not None
    name, plan = sel.recommend(get_config("phi3.5-moe-42b-a6.6b"),
                               SHAPES["train_4k"], 16, 16)
    assert name == "fsdp"
    name2, _ = sel.recommend(get_config("llama3.2-1b"), SHAPES["train_4k"],
                             16, 16)
    assert name2 == "baseline"


def test_plan_selector_analytic_fallback():
    sel = PlanSelector()  # not fitted
    name, plan = sel.recommend(get_config("phi3.5-moe-42b-a6.6b"),
                               SHAPES["train_4k"], 16, 16)
    assert isinstance(plan, ExecutionPlan)
    assert name in CANDIDATE_PLANS


def test_workload_features_finite():
    f = workload_features(get_config("jamba-v0.1-52b"), SHAPES["decode_32k"],
                          16, 16)
    assert np.isfinite(f).all()


# -- parity with the reference ---------------------------------------------------

def _records():
    """Every plan of every arch × shape on both meshes, seeded: dominant
    terms of 1-3 s and residencies of 4-40 GB (past 16e9 the reference's
    overflow penalty reorders the plans), a few failed records (scored
    infinite) and reference-written plan dicts (``scan_layers``)."""
    rng = np.random.default_rng(7)
    arts = []
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            for mesh, _, _ in MESHES:
                for name in CANDIDATE_PLANS:
                    rec = _fake_record(arch, shape, mesh, name,
                                       float(rng.uniform(1.0, 3.0)),
                                       float(rng.uniform(4e9, 40e9)))
                    rec["plan"]["scan_layers"] = True
                    if rng.uniform() < 0.1:
                        rec["status"] = "cannot run: a test"
                    arts.append(rec)
    return arts


@pytest.mark.parametrize("learned", [True, False])
def test_plan_selector_matches_the_reference(learned):
    arts = _records()
    ref = RefSelector(min_samples=8)
    port = PlanSelector(min_samples=8, hbm_bytes=REF_HBM)
    if learned:
        ref.fit(artifacts=arts)
        port.fit(artifacts=arts)
        assert ref.model is not None and port.model is not None
        x_ref, y_ref = ref.build_dataset(arts)
        x, y = port.build_dataset(arts)
        assert x.dtype == x_ref.dtype == np.float64
        np.testing.assert_array_equal(x, x_ref)
        np.testing.assert_array_equal(y, y_ref)
        assert np.unique(y).size > 2
    names = set()
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            for _, n_data, n_model in MESHES:
                want, _ = ref.recommend(ref_config(arch), REF_SHAPES[shape],
                                        n_data, n_model)
                got, plan = port.recommend(get_config(arch), SHAPES[shape],
                                           n_data, n_model)
                assert got == want, (arch, shape, n_data)
                assert plan == CANDIDATE_PLANS[got]
                names.add(got)
    if not learned:
        assert names == {"baseline", "fsdp_ep"}  # 42B and 52B MoE


def test_plan_label_reads_reference_records():
    """A reference record's plan dict carries ``scan_layers: true``; the
    port's plan has no such field, and the label ignores it."""
    from repro.autotune import CANDIDATE_PLANS as REF_PLANS
    from repro.autotune import plan_label as ref_label

    for name, plan in REF_PLANS.items():
        assert plan.scan_layers is True
        assert plan_label(dict(plan.__dict__)) == name
        assert ref_label(dict(plan.__dict__)) == name
    assert plan_label(dict(fsdp_params=True, remat="none")) == "custom"


def test_workload_features_match_the_reference_exactly():
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            for n_data, n_model in ((16, 16), (32, 16), (1, 1)):
                got = workload_features(get_config(arch), SHAPES[shape],
                                        n_data, n_model)
                want = ref_features(ref_config(arch), REF_SHAPES[shape],
                                    n_data, n_model)
                assert got.dtype == want.dtype == np.float64
                np.testing.assert_array_equal(got, want)


def test_the_selector_imports_nothing_of_the_dry_run():
    """The selector sits below the dry run: it reads the dry run's records
    from disk and imports neither ``launch`` nor ``train``, so a serving
    process that loads ``repro_torch.autotune`` does not load the trainer."""
    import ast

    import repro_torch.autotune.plan_selector as ps
    with open(ps.__file__) as f:
        tree = ast.parse(f.read())
    names = [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names]
    assert names
    assert not [m for m in names if m.split(".")[0] in ("launch", "train")
                or ".launch" in m or ".train" in m], names
