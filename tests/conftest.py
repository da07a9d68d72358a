"""Pytest config.  NOTE: no XLA_FLAGS here — tests must see 1 device;
multi-device tests spawn subprocesses (via :func:`run_subprocess`) and only
the dry-run sets the 512-device flag (launch/dryrun.py)."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    # Two example budgets for the property suites: "tier1" keeps the
    # default run fast (tests that pin their own ``@settings`` are
    # unaffected); the tier-2 ``tests-extended`` CI job raises it with
    # ``--hypothesis-profile=ci`` (the pytest plugin's CLI flag wins over
    # the ``load_profile`` default below).
    from hypothesis import settings as _hyp_settings
    _hyp_settings.register_profile("tier1", max_examples=5, deadline=None)
    _hyp_settings.register_profile("ci", max_examples=40, deadline=None)
    _hyp_settings.load_profile("tier1")
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute tests (subprocess compiles, drills)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips elsewhere)")


def run_subprocess(body: str, devices: int = 8) -> str:
    """Run a multi-device test body in a fresh interpreter with
    ``--xla_force_host_platform_device_count=devices`` (the main pytest
    process must keep seeing exactly 1 device).  Asserts a zero exit and
    returns stdout."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, \
        f"stdout:\n{p.stdout}\nstderr:\n{p.stderr[-4000:]}"
    return p.stdout
