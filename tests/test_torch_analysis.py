"""The port's analysis passes (``repro_torch.analysis``), on the CPU: each
reports on ``tests/fixtures_analysis/`` exactly what
``tests/test_analysis_passes.py`` expects of JAX's (seeded lock escapes,
broad excepts, nested stages and lambda tasks, baseline keys without line
numbers, lock-order cycles and clean nesting, the agent's live
interleaving); each AST pass gives JAX's pass's findings, finding for
finding, on the fixtures and on the port's own runtime files; the kernel
pass flags a bad GQA grid, a head dim no kernel is built for and a step
that breaks its output contract; the host-sync pass (``jit``) reports
exactly the syncs seeded in ``tests/torch_host_sync_fixture.py``, has a
counterpart for every jit root JAX's pass discovers, and is clean on the
serving steps; and ``python -m repro_torch.analysis`` exits 0 on the port
against ``analysis-baseline-torch.json``, which makes it a tier-1 gate."""
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import excepts as jexcepts  # noqa: E402
from repro.analysis import locks as jlocks  # noqa: E402
from repro.analysis import pickles as jpickles  # noqa: E402
from repro.analysis import timeouts as jtimeouts  # noqa: E402
from repro.analysis import jit_boundary as jjit  # noqa: E402
from repro_torch.analysis import (excepts, host_sync, kernel_contracts, locks,  # noqa: E402
                                  pickles, timeouts)
from repro_torch.analysis.__main__ import LOCK_FILES, SRC_ROOT, TIMEOUT_FILES  # noqa: E402
from repro_torch.analysis.findings import (  # noqa: E402
    Finding, diff_against_baseline, load_baseline, write_baseline,
)
from repro_torch.analysis.kernel_contracts import blockspec_findings, head_dim_findings  # noqa: E402
from repro_torch.analysis.lockorder import LockOrderRecorder, instrument_runtime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.pilot import Pilot  # noqa: E402
from repro_torch.core.task import ServicePreempted, TaskDescription  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures_analysis"
PASSES = {"locks": (locks, jlocks), "excepts": (excepts, jexcepts),
          "pickles": (pickles, jpickles), "timeouts": (timeouts, jtimeouts)}


def _rows(findings):
    return [(f.pass_name, f.rule, f.file, f.line, f.symbol, f.message) for f in findings]


# ---------------------------------------------------------------------------
# the AST passes: JAX's expectations, and JAX's passes' own findings
# ---------------------------------------------------------------------------


def test_lock_pass_reports_exactly_the_seeded_escapes():
    findings = locks.run([FIXTURES / "lock_fixture.py"], ROOT)
    assert sorted((f.rule, f.symbol) for f in findings) == [
        ("guarded-attr", "Counter.history"), ("guarded-attr", "Counter.value")]
    by_symbol = {f.symbol: f for f in findings}
    assert "peek" not in by_symbol
    assert "_lock" in by_symbol["Counter.value"].message


def test_excepts_pass_respects_noqa_boundary():
    findings = excepts.run([FIXTURES / "except_fixture.py"], ROOT)
    assert len(findings) == 1
    assert findings[0].rule == "broad-except" and findings[0].line == 11


def test_pickles_pass_flags_nested_stage_and_lambda_task():
    findings = pickles.run([FIXTURES / "pickle_fixture.py"], ROOT)
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert [f.symbol for f in by_rule.get("stage-nested", [])] == ["inner_stage"]
    assert len(by_rule.get("lambda-task", [])) == 1
    assert by_rule["lambda-task"][0].symbol == "TaskDescription"
    assert len(findings) == 2


@pytest.mark.parametrize("name", sorted(PASSES))
def test_ast_pass_gives_jaxs_findings(name):
    """On every fixture and on the port's files the pass reads (the lock
    files, the timeout files, the whole package), the port's pass and
    JAX's give the same findings."""
    port, jax_pass = PASSES[name]
    files = {"locks": LOCK_FILES, "timeouts": TIMEOUT_FILES}.get(
        name, sorted(SRC_ROOT.rglob("*.py")))
    for paths in ([p] for p in sorted(FIXTURES.glob("*_fixture.py"))):
        assert _rows(port.run(paths, ROOT)) == _rows(jax_pass.run(paths, ROOT))
    assert _rows(port.run(files, ROOT)) == _rows(jax_pass.run(files, ROOT)) == []


def test_port_sources_carry_jaxs_markers():
    """The five findings JAX's passes gave on the port's files, repaired as
    JAX marks its own: the session's cleanup handler, the training
    driver's three in-process stages, the checkpointer's deliberate wait."""
    src = (SRC_ROOT / "launch" / "train.py").read_text()
    assert src.count("# noqa: PKL001") == 3
    assert "except BaseException:  # noqa: BLE001" in (
        SRC_ROOT / "core" / "session.py").read_text()
    assert "self._q.join()  # noqa: TMO001" in (
        SRC_ROOT / "checkpoint" / "store.py").read_text()


# ---------------------------------------------------------------------------
# baseline protocol
# ---------------------------------------------------------------------------


def test_baseline_diff_keys_exclude_line_numbers(tmp_path):
    f1 = Finding("locks", "guarded-attr", "a.py", 10, "C.x", "m")
    moved = Finding("locks", "guarded-attr", "a.py", 99, "C.x", "m")
    other = Finding("locks", "guarded-attr", "a.py", 5, "C.y", "m")
    path = tmp_path / "baseline.json"
    write_baseline(path, [f1])
    baseline = load_baseline(path)
    new, stale = diff_against_baseline([moved], baseline)
    assert new == [] and stale == set()
    new, stale = diff_against_baseline([other], baseline)
    assert [f.symbol for f in new] == ["C.y"]
    new, stale = diff_against_baseline([], baseline)
    assert new == [] and stale == {f1.key()}


# ---------------------------------------------------------------------------
# lock-order recorder
# ---------------------------------------------------------------------------


def test_lock_order_cycle_detected_from_sequential_threads():
    rec = LockOrderRecorder()
    a = rec.wrap(threading.Lock(), "A")
    b = rec.wrap(threading.Lock(), "B")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for body in (forward, backward):
        t = threading.Thread(target=body)
        t.start()
        t.join()
    assert rec.cycles() == [["A", "B", "A"]]
    with pytest.raises(AssertionError, match="A -> B -> A"):
        rec.assert_no_cycles()


def test_lock_order_clean_nesting_has_no_cycle():
    rec = LockOrderRecorder()
    a = rec.wrap(threading.Lock(), "A")
    b = rec.wrap(threading.Lock(), "B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert rec.cycles() == []
    rec.assert_no_cycles()


class _FakeDevice:
    def __init__(self, i):
        self.id = i
        self.platform = "cpu"


class _FakePilot(Pilot):
    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="fake", build_time_s=0.0)


def test_agent_submit_and_preempt_interleaving_is_cycle_free():
    pilot = _FakePilot("fake.2", [_FakeDevice(i) for i in range(2)])
    agent = RemoteAgent(pilot, max_workers=2, straggler_check_s=0.01)
    rec = LockOrderRecorder()
    instrument_runtime(rec, agent=agent)
    rec.instrument(pilot, "_lock", "pilot._lock")

    def service(comm, control=None, resume_state=None):
        while True:
            control.wait_for_work(0.05)
            if control.preempt_requested():
                raise ServicePreempted(state="ckpt")
            if control.stop_requested():
                return "stopped"
            control.take_requests()

    def unit(comm):
        return "ok"

    try:
        [svc] = agent.submit_async([TaskDescription(
            name="svc", fn=service, num_devices=2, priority=0, service=True)])
        started = threading.Event()
        svc.description.control.submit_request("warm")

        def submitter():
            started.wait(5.0)
            tasks = agent.submit_async(
                [TaskDescription(name=f"hi{i}", fn=unit, num_devices=2,
                                 priority=5) for i in range(4)])
            agent.wait(tasks, timeout=10.0)

        def driver():
            started.set()
            for i in range(20):
                try:
                    svc.description.control.submit_request(i)
                except RuntimeError:
                    break

        threads = [threading.Thread(target=submitter), threading.Thread(target=driver)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15.0)
        svc.description.control.stop()
        svc.wait(10.0)
    finally:
        agent.close(timeout=10.0)

    assert agent.preemption_requests >= 1
    assert rec.edges(), "recorder saw no lock activity"
    rec.assert_no_cycles()


def test_instrument_runtime_wraps_the_subprocess_transports_locks():
    from repro_torch.core.exec import SubprocessTransport

    transport = SubprocessTransport.__new__(SubprocessTransport)
    transport._cond = threading.Condition()
    transport._streams = SimpleNamespace(_lock=threading.Lock())
    rec = LockOrderRecorder()
    instrument_runtime(rec, transport=transport)
    with transport._cond:
        with transport._streams._lock:
            pass
    assert rec.edges() == {"transport._cond": {"transport._streams._lock"}}


# ---------------------------------------------------------------------------
# kernel-contract pass
# ---------------------------------------------------------------------------


def test_kernel_pass_flags_blockspec_misdivision():
    bad = SimpleNamespace(padded_gqa=lambda: (6, 4))
    findings = blockspec_findings("badfixture", bad)
    assert [f.rule for f in findings] == ["blockspec"]
    assert findings[0].symbol == "badfixture/gqa" and "H %" in findings[0].message
    assert blockspec_findings("goodfixture", SimpleNamespace(padded_gqa=lambda: (8, 4))) == []


def test_kernel_pass_flags_a_head_dim_no_kernel_is_built_for():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    assert head_dim_findings("tiny", cfg) == []
    bad = cfg.with_overrides(head_dim=48, d_model=cfg.num_heads * 48)
    findings = head_dim_findings("tiny48", bad)
    assert sorted(f.symbol for f in findings) == [
        "tiny48/decode_attention", "tiny48/decode_attention_paged",
        "tiny48/prefill_attention", "tiny48/prefill_attention_paged"]
    assert all("head dim 48" in f.message for f in findings)


def test_kernel_pass_flags_a_broken_step_contract(monkeypatch):
    """A decode step that drops a vocabulary column and a chunk step that
    returns another cache tree are findings; the real steps give none."""
    from repro_torch.train import step as S

    cfg = get_config("tinyllama-1.1b", smoke=True)
    clean = []
    kernel_contracts._check_supported("tiny", cfg, clean)
    assert clean == []
    real_decode, real_chunk = S.make_decode_step, S.make_prefill_chunk_step

    def bad_decode(c, run_cfg=None):
        step = real_decode(c, run_cfg)
        return lambda *a: (lambda nt, lg, nc: (nt, lg[..., :-1], nc))(*step(*a))

    def bad_chunk(c, run_cfg=None):
        step = real_chunk(c, run_cfg)
        return lambda *a: (lambda nt, lg, nc: (nt, lg, {"layers": []}))(*step(*a))

    monkeypatch.setattr(S, "make_decode_step", bad_decode)
    monkeypatch.setattr(S, "make_prefill_chunk_step", bad_chunk)
    found = []
    kernel_contracts._check_supported("tiny", cfg, found)
    symbols = {f.symbol for f in found}
    assert {"tiny/contiguous/decode", "tiny/paged/decode"} <= symbols
    assert {f"tiny/{lay}/prefill_chunk@T{t}" for lay in ("contiguous", "paged")
            for t in (4, 8)} <= symbols
    assert not any("prefill@" in s for s in symbols)


def test_kernel_pass_is_clean_on_the_config_matrix():
    assert kernel_contracts.run() == []


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_cli_is_clean_against_the_ports_baseline():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean:" in out.stdout
    assert (ROOT / "analysis-baseline-torch.json").exists()


# ---------------------------------------------------------------------------
# the host-sync pass (``jit``): the twin of JAX's jit-boundary pass
# ---------------------------------------------------------------------------

FIXTURE_ROOTS = (host_sync.Root("torch_host_sync_fixture", "make_leaky_step", "factory"),
                 host_sync.Root("torch_host_sync_fixture", "clean_step"))


def test_host_sync_pass_reports_exactly_the_seeded_syncs():
    findings = host_sync.run(
        {"torch_host_sync_fixture": ROOT / "tests" / "torch_host_sync_fixture.py"},
        ROOT, roots=FIXTURE_ROOTS)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("host-sync", 23),      # .tolist() in the helper leaky_step calls
        ("host-sync", 28),      # time.perf_counter() in a step
        ("host-sync", 32),      # float() of a tensor
        ("host-sync", 33),      # .item()
        ("host-sync", 34),      # boolean-mask indexing
        ("host-sync", 35),      # torch.nonzero
        ("host-sync", 36),      # np.asarray of a tensor
        ("host-sync", 37),      # .to("cpu")
        ("host-sync", 38),      # repeat_interleave with tensor repeats
        ("host-sync", 39),      # torch.cuda.synchronize()
        ("traced-branch", 30),  # if on a tensor
        ("traced-branch", 40),  # while on a tensor
    ]
    # every finding names its function; clean_step (shapes, devices,
    # static keyword-only parameters, int repeats, a marked read) gives none
    assert {f.symbol for f in findings} == {"leaky_step", "_to_host"}
    assert all(f.pass_name == "jit" for f in findings)


def test_every_jax_jit_root_has_a_counterpart():
    """JAX's pass discovers its roots in ``src/repro``; each one is named
    by an entry of the port's root table, or stands in NO_COUNTERPART
    with its reason."""
    from repro.analysis.__main__ import REPO_ROOT, _src_modules

    jax_roots = {f"{mod.name}.{fn.name}" for mod, fn, _ in
                 jjit.JitBoundaryPass(_src_modules(), REPO_ROOT).discover_roots()}
    assert len(jax_roots) >= 12
    named = {j for r in host_sync.ROOTS for j in r.jax}
    missing = jax_roots - named - set(host_sync.NO_COUNTERPART)
    assert not missing, missing
    assert not named - jax_roots, "a root table entry names no JAX root"
    assert all(host_sync.NO_COUNTERPART.values())


def test_every_root_of_the_table_resolves():
    p = host_sync.HostSyncPass(host_sync.src_modules(SRC_ROOT), ROOT)
    got = {(m.name, fn.name) for m, fn, _ in p.resolve_roots()}
    for name in ("train_step", "loss_fn", "prefill_step", "last_logits_step",
                 "chunk_step", "decode_step"):
        assert ("repro_torch.train.step", name) in got, name
    assert ("repro_torch.bridge.loader", "_gather") in got
    assert ("repro_torch.serve.sampling", "sample_tokens") in got
    assert sum(m == "repro_torch.kernels.ops" for m, _ in got) == 8


@pytest.mark.parametrize("factory", ["make_decode_step", "make_prefill_chunk_step"])
def test_host_sync_pass_is_clean_on_the_serving_steps(factory):
    roots = [r for r in host_sync.ROOTS if r.name == factory]
    assert host_sync.run(host_sync.src_modules(SRC_ROOT), ROOT, roots=roots) == []


def test_host_sync_pass_needs_a_reason_to_be_quiet(tmp_path):
    """``# sync-ok`` without a reason suppresses nothing; the prefill's
    marked base probe is reached from make_prefill_step."""
    src = tmp_path / "m.py"
    src.write_text("def step(x):\n    a = x.item()  # sync-ok\n"
                   "    b = x.item()  # sync-ok: counted once a call\n    return a, b\n")
    got = host_sync.run({"m": src}, tmp_path, roots=[host_sync.Root("m", "step")])
    assert [(f.rule, f.line) for f in got] == [("host-sync", 2)]
    line = next(i for i, t in enumerate(
        (SRC_ROOT / "models" / "blocks.py").read_text().splitlines(), 1)
        if "int(raw_len) != 0" in t)
    unmarked = (SRC_ROOT / "models" / "blocks.py").read_text().replace(
        "# sync-ok: the no-chunk prefill's probe of its base", "")
    files = host_sync.src_modules(SRC_ROOT)
    (tmp_path / "blocks.py").write_text(unmarked)
    files["repro_torch.models.blocks"] = tmp_path / "blocks.py"
    roots = [r for r in host_sync.ROOTS if r.name == "make_prefill_step"]
    got = host_sync.run(files, tmp_path, roots=roots)
    assert [(f.rule, f.line, f.symbol) for f in got] == [
        ("host-sync", line, "_check_prefill_base")]


def test_cli_exit_codes_and_the_jit_pass_not_ported(tmp_path, capsys, monkeypatch):
    """JAX's exit codes: 0 clean, 1 on a finding outside the baseline, 0
    again once ``--write-baseline`` has taken it in; ``jit`` runs, as in
    JAX (its pass was once not ported, hence the name)."""
    from repro_torch.analysis import __main__ as cli

    baseline = str(tmp_path / "b.json")
    assert cli.main(["--passes", "jit,excepts", "--baseline", baseline]) == 0
    out = capsys.readouterr().out
    assert "pass jit     : 0 finding(s)" in out and "not ported" not in out
    src = tmp_path / "src"
    src.mkdir()
    (src / "bad.py").write_text("try:\n    pass\nexcept Exception:\n    pass\n")
    monkeypatch.setattr(cli, "SRC_ROOT", src)
    assert cli.main(["--passes", "excepts", "--baseline", baseline]) == 1
    assert "DIRTY: 1 new finding" in capsys.readouterr().out
    assert cli.main(["--passes", "excepts", "--baseline", baseline,
                     "--write-baseline"]) == 0
    assert cli.main(["--passes", "excepts", "--baseline", baseline]) == 0
