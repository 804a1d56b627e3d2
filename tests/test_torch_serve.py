"""Port parity for the serving path: ServeEngine, the launcher, and the
port's import boundary.

The port's ``ServeEngine`` and the reference's, each with the same SMOKE
weights (``params_from_jax``), serve the same numpy prompts on 4 slots.
Greedy tokens must be identical, token for token.  One deliberate
difference is pinned: the reference prefills a refilled slot from the
state its previous occupant left (ROADMAP.md Queue 3), the port from zeros.
So requests that refill a slot are held against the reference serving them
on a fresh engine, and the reference's own refill is shown to differ.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import build as R_build
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
SMOKE = configs.get_smoke("falcon-mamba-7b")
R_SMOKE = R_configs.get_smoke("falcon-mamba-7b")
PROMPT_LENS = (5, 9, 3, 12, 7, 4)
MAX_NEW, SLOTS, MAX_LEN = 8, 4, 64


@pytest.fixture(scope="module")
def models():
    rb = R_build(R_SMOKE)
    rparams = rb.init(jax.random.PRNGKey(0))
    port = params_from_jax(jax.tree.map(np.asarray, rparams), SMOKE,
                           device="cpu")
    return rb, rparams, build(SMOKE), port


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(v) for v in rng.integers(0, SMOKE.vocab, n)]
            for n in PROMPT_LENS]


def ref_run(models, prompts, **kw):
    rb, rparams, _, _ = models
    eng = R_ServeEngine(rb, rparams, batch_slots=SLOTS,
                        max_len=kw.pop("max_len", MAX_LEN), **kw)
    reqs = [R_Request(prompt=p, max_new_tokens=MAX_NEW, rid=i)
            for i, p in enumerate(prompts)]
    return [r.output for r in eng.run(reqs)]


def port_run(models, prompts, temps=None, **kw):
    _, _, bundle, params = models
    eng = ServeEngine(bundle, params, batch_slots=SLOTS,
                      max_len=kw.pop("max_len", MAX_LEN), **kw)
    temps = temps or [0.0] * len(prompts)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW, rid=i, temperature=t)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    return [r.output for r in eng.run(reqs)]


@pytest.fixture(scope="module")
def ref_outputs(models, prompts):
    """The reference engine on all six requests, and on the first four and
    the last two separately (fresh slots for all)."""
    return {"all": ref_run(models, prompts),
            "fresh": ref_run(models, prompts[:4]) + ref_run(models, prompts[4:])}


class TestServeEngine:
    def test_greedy_tokens_match_reference(self, models, prompts, ref_outputs):
        got = port_run(models, prompts)
        assert all(len(o) == MAX_NEW for o in got)
        assert got == ref_outputs["fresh"]
        # the first four never share a slot with an earlier request
        assert got[:4] == ref_outputs["all"][:4]

    def test_reference_refill_starts_from_a_stale_state(self, ref_outputs):
        """The reference's refilled slots (requests 4 and 5) continue the
        previous occupant's conv/SSM state, so at least one of them differs
        from the same request served on a fresh engine."""
        assert ref_outputs["all"][:4] == ref_outputs["fresh"][:4]
        assert ref_outputs["all"][4:] != ref_outputs["fresh"][4:]

    def test_refill_equals_a_fresh_engine(self, models, prompts):
        assert port_run(models, prompts)[4:] == port_run(models, prompts[4:])

    def test_max_len_and_eos_match_reference(self, models, prompts):
        short = [p[:3] for p in prompts[:2]]
        got = port_run(models, short, max_len=8)
        assert got == ref_run(models, short, max_len=8)
        assert all(len(o) == 8 - 1 - 3 + 1 for o in got)
        eos = got[0][1]
        assert port_run(models, short, eos_id=eos) == \
            ref_run(models, short, eos_id=eos)

    def test_sampled_request(self, models, prompts):
        """A request at temperature 0.8 gets valid tokens, the same ones
        again from the same seed, and leaves the greedy rows untouched."""
        temps = [0.0, 0.8, 0.0, 0.0, 0.0, 0.0]
        a = port_run(models, prompts, temps=temps, seed=3)
        b = port_run(models, prompts, temps=temps, seed=3)
        greedy = port_run(models, prompts)
        assert a == b
        assert len(a[1]) == MAX_NEW
        assert all(0 <= v < SMOKE.vocab for v in a[1])
        assert [o for i, o in enumerate(a) if i != 1] == \
            [o for i, o in enumerate(greedy) if i != 1]


class TestEntryPoints:
    def test_launcher_on_cpu(self, capsys):
        outs = launch_serve.main(["--arch", "falcon-mamba-7b", "--smoke",
                                  "--device", "cpu", "--requests", "5",
                                  "--max-new", "3"])
        assert [len(r.output) for r in outs] == [3] * 5
        assert "tok/s across 4 slots on cpu" in capsys.readouterr().out

    def test_entry_points_need_cuda_unless_given_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is available here: the default device works")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--arch", "falcon-mamba-7b", "--smoke"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(SMOKE).init(0)
        assert build(SMOKE).init(0, "cpu").embed.device.type == "cpu"

    def test_checkpoint_restore_waits(self):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            launch_serve.main(["--arch", "falcon-mamba-7b", "--smoke",
                               "--device", "cpu", "--ckpt", "/nonexistent"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_port_modules_import_with_jax_and_the_reference_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
