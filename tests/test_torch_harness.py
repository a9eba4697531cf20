"""The harness that the port's twin tests share, and its tier-1 tests.

``jax_child`` starts a JAX replay (a function of a module in tests/) in a
child process with the CPU client's dispatch chosen and, while a port
module runs, the run's persistent compile cache;
``jax_result`` waits for it under a limit of its own and fails the test,
with the child's output, if the child runs past it. ``jax_compile_cache``
is the module-scoped autouse fixture that each port test module imports:
it points the module's own JAX compiles and its children at the run's
cache and undoes that at the module's end.

Tier-1 here (a few seconds, CPU only): a child that sleeps past a tiny
limit is killed and its test fails with the child's output; a child
started inside a port module compiles into the run's cache, as the module
does, while this process's environment stays as it was; the cache setting
is undone on the way out of a module; the run's last user of the cache
removes it; a module starts its children only where a selected test reads
them; every module whose module fixture starts a JAX child queues after
tests/test_gvins_long_e2e.py.
"""

import ast
import collections
import contextlib
import fcntl
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import time
import types

import jax
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
# JAX replays run in a child process with the CPU client's async dispatch
# off: with it on, a device read of a host mirror can race the mirror's
# in-place edit, and a JAX trajectory then moves with the load of the
# machine (ROADMAP R3). With it off a JAX replay is the same under any load
# and equals a run alone. A tier-1 process has started its CPU client before
# a fixture runs, so the setting needs a process of its own.
_JAX_CHILD = ("import importlib, sys; sys.path[:0] = sys.argv[1:3]; import conftest, jax; "
              "jax.config.update('jax_cpu_enable_async_dispatch', sys.argv[3] == 'async'); "
              "module, name = sys.argv[4].split(':'); getattr(importlib.import_module(module), name)(*sys.argv[5:])")

# The run's persistent JAX compile cache (``jax_compile_cache``): the port's
# test modules and the children they start compile each program once per
# run. A cache entry takes a small compile too: the twins' worlds and
# estimators are many small programs that every process compiles again.
# A child's threads are not bounded: with XLA's Eigen pool off and one
# BLAS thread the JAX replay of tests/test_torch_gvins_twin.py took 188.6 s
# alone instead of 143.6 s and no less CPU time (342.7 s against 319.0 s),
# its positions moved by 1.1e-11 m, and its compiles would key apart from
# the workers' in the cache (XLA_FLAGS is part of the key).
_CACHE_CONFIG = {"jax_persistent_cache_min_compile_time_secs": 0.0}
_cache = {"dir": None, "joined": None}


def child_env():
    """The environment of a JAX child: this process's and, while a port
    module runs, the run's compile cache."""
    env = dict(os.environ)
    if _cache["dir"]:
        env["JAX_COMPILATION_CACHE_DIR"] = _cache["dir"]
        env.update({name.upper(): str(value) for name, value in _CACHE_CONFIG.items()})
    return env


def jax_child(target, *args, dispatch="sync"):
    """Start ``module:function(*args)`` of tests/ in a child process, the JAX
    CPU client's dispatch ``sync`` or ``async`` (``child_env``)."""
    return subprocess.Popen([sys.executable, "-c", _JAX_CHILD, TESTS, os.path.dirname(TESTS), dispatch, target,
                             *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=child_env())


def kill_if_running(child):
    """A module fixture's end: its child killed if the tests left it
    running."""
    if child.poll() is None:
        child.kill()
        child.communicate()


def jax_result(child, out_path, *, timeout):
    """Wait for a ``jax_child``, at most ``timeout`` seconds from this call
    (until then the child ran beside the test's own half); returns what it
    pickled to out_path. A child past its limit is killed and fails the
    test with its output, so that a child that hangs costs one test and not
    the suite's time."""
    try:
        out, _ = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        out, _ = child.communicate()
        pytest.fail(f"JAX child killed at its {timeout} s limit; its output:\n{out}", pytrace=False)
    assert child.returncode == 0, out
    with open(out_path, "rb") as f:
        return pickle.load(f)


def module_reads(request, fixture):
    """Whether a test of the requesting module that this session runs uses
    ``fixture``: a module fixture starts a JAX child only then."""
    return any(fixture in item.fixturenames for item in request.session.items if item.module is request.module)


# The run's longest file, a JAX replay of a 120 s world. With pytest-xdist's
# ``--dist loadfile`` the files queue by their count of selected tests, most
# first, ties in collection order (by path); each worker starts with up to
# two and takes the next when at most two of its tests are pending. A module
# that waits on a JAX child therefore holds no more tests than this file and
# sorts after it, so that its wait does not hold back the replay's start.
LONG_REPLAY = "test_gvins_long_e2e.py"


def _module_fixture(func):
    """Whether ``func`` is decorated ``@pytest.fixture(scope="module", ...)``."""
    return any(isinstance(d, ast.Call) and ast.unparse(d.func) == "pytest.fixture"
               and any(k.arg == "scope" and ast.literal_eval(k.value) == "module" for k in d.keywords)
               for d in func.decorator_list)


def starts_children(path):
    """Whether the test module at ``path`` has a module-scoped fixture that
    starts a JAX child: one that calls ``jax_child``, itself or through
    functions of the module."""
    tree = ast.parse(pathlib.Path(path).read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    calls = {name: {c.func.id for c in ast.walk(f) if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
             for name, f in funcs.items()}
    reach, more = set(), {"jax_child"}
    while more:
        reach |= more
        more = {name for name, called in calls.items() if called & reach} - reach
    return any(name in reach and _module_fixture(f) for name, f in funcs.items())


def _cache_users(root, path, delta):
    """Counts the processes of this run that use the compile cache, under a
    lock; the last one to leave removes the cache, so that none outlives
    the run."""
    with open(root / "jax_compile_cache.users", "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        n = int(f.read() or 0) + delta
        f.seek(0)
        f.truncate()
        f.write(str(n))
        f.flush()
        if n == 0:
            shutil.rmtree(path, ignore_errors=True)


@contextlib.contextmanager
def compile_cache(path):
    """Points this process's JAX compiles, and the children that
    ``jax_child`` starts meanwhile, at the persistent cache in ``path``;
    restores the settings it found on the way out."""
    from jax._src import compilation_cache

    saved = {name: getattr(jax.config, name) for name in (*_CACHE_CONFIG, "jax_compilation_cache_dir")}
    saved_dir = _cache["dir"]
    for name, value in {**_CACHE_CONFIG, "jax_compilation_cache_dir": str(path)}.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    _cache["dir"] = str(path)
    try:
        yield path
    finally:
        _cache["dir"] = saved_dir
        for name, value in saved.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(request, tmp_path_factory):
    """The run's persistent JAX compile cache, for the tests of a port module
    that imports this fixture and the children they start. It lies under the
    temporary root that pytest makes for each run (the workers of one xdist
    run share it), and the session's last user removes it (a run killed at
    its time limit leaves it in that root, which no later run reads). The
    setting is made here and undone at the module's end (``compile_cache``),
    so that the JAX package's test files in the same worker run as they
    always did."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "jax_compile_cache"
    if _cache["joined"] != str(path):
        _cache_users(root, path, +1)
        request.session.addfinalizer(lambda: _cache_users(root, path, -1))
        _cache["joined"] = str(path)
    with compile_cache(path):
        yield path


def sleep_past(marker, seconds):
    """A child that says it started, writes ``marker`` and sleeps."""
    print("child started, sleeping", flush=True)
    with open(marker, "w") as f:
        f.write("started")
    time.sleep(float(seconds))


def report_env(out_path):
    """A child that pickles which compile cache it uses."""
    with open(out_path, "wb") as f:
        pickle.dump((os.environ.get("JAX_COMPILATION_CACHE_DIR"), jax.config.jax_compilation_cache_dir,
                     jax.config.jax_persistent_cache_min_compile_time_secs), f)


def test_child_past_its_limit_is_killed_and_fails_its_test(tmp_path):
    marker, out_path = tmp_path / "started", tmp_path / "never.pkl"
    child = jax_child("test_torch_harness:sleep_past", str(marker), "600")
    deadline = time.monotonic() + 120
    while not marker.exists() and child.poll() is None and time.monotonic() < deadline:
        time.sleep(0.1)
    assert marker.exists(), child.communicate()[0]
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="killed at its 1 s limit") as failed:
        jax_result(child, str(out_path), timeout=1)
    assert time.monotonic() - t0 < 30
    assert "child started, sleeping" in str(failed.value)
    assert child.returncode is not None and child.returncode != 0
    assert not out_path.exists()


def test_child_and_module_use_the_run_cache(tmp_path, jax_compile_cache):
    """A child started inside a port module compiles into the run's cache,
    as the module does; this process's environment is left as it was."""
    out_path = tmp_path / "env.pkl"
    env_dir, cache_dir, min_secs = jax_result(jax_child("test_torch_harness:report_env", str(out_path)),
                                              str(out_path), timeout=120)
    assert env_dir == cache_dir == jax.config.jax_compilation_cache_dir == str(jax_compile_cache)
    assert min_secs == jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    assert "JAX_COMPILATION_CACHE_DIR" not in os.environ
    root = tmp_path.parents[1] if os.environ.get("PYTEST_XDIST_WORKER") else tmp_path.parent
    assert jax_compile_cache.parent == root and (root / "jax_compile_cache.users").exists()


def test_compile_cache_is_undone_on_the_way_out(tmp_path, jax_compile_cache):
    """Inside ``compile_cache`` a compile lands in its directory; on the way
    out the settings it found come back (the module's here, none in a JAX
    package module), and a later compile writes nothing there."""
    def entries():
        return sorted(p.name for p in (tmp_path / "cache").glob("*")) if (tmp_path / "cache").exists() else []

    with compile_cache(tmp_path / "cache"):
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cache")
        assert child_env()["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path / "cache")
        jax.jit(lambda x: x * 3.0 + 0.125)(jax.numpy.arange(7.0)).block_until_ready()
        inside = entries()
    assert inside
    assert jax.config.jax_compilation_cache_dir == child_env()["JAX_COMPILATION_CACHE_DIR"] == str(jax_compile_cache)
    jax.jit(lambda x: x * 5.0 - 0.375)(jax.numpy.arange(7.0)).block_until_ready()
    assert entries() == inside


def test_last_user_removes_the_cache(tmp_path):
    """``_cache_users``: the cache stays while any process of the run uses
    it, and the last one to leave removes it."""
    path = tmp_path / "jax_compile_cache"
    _cache_users(tmp_path, path, +1)
    _cache_users(tmp_path, path, +1)
    path.mkdir()
    (path / "entry").write_bytes(b"x")
    _cache_users(tmp_path, path, -1)
    assert (path / "entry").exists()
    _cache_users(tmp_path, path, -1)
    assert not path.exists()
    assert (tmp_path / "jax_compile_cache.users").read_text() == "0"


def test_children_start_only_for_modules_that_read_them():
    """``module_reads``: a module fixture starts its JAX child only where a
    selected test of that module uses the fixture that waits for it."""
    mod, other = object(), object()
    item = lambda module, *names: types.SimpleNamespace(module=module, fixturenames=list(names))  # noqa: E731
    request = types.SimpleNamespace(module=mod, session=types.SimpleNamespace(items=[
        item(mod, "jax_compile_cache", "tmp_path"), item(other, "replays"), item(mod, "jax_compile_cache", "twins")]))
    assert module_reads(request, "twins")
    assert not module_reads(request, "replays")
    request.session.items.pop()
    assert not module_reads(request, "twins")


def test_child_modules_queue_after_the_long_replay(request):
    """Every selected module whose module fixture starts a JAX child holds
    no more selected tests than tests/test_gvins_long_e2e.py and sorts after
    it, so that xdist's loadfile queue hands it out after that file."""
    assert starts_children(os.path.join(TESTS, "test_torch_faults.py"))         # through a helper
    assert starts_children(os.path.join(TESTS, "test_torch_gvins_twin.py"))
    assert not starts_children(os.path.join(TESTS, "test_torch_gvins.py"))
    counts = collections.Counter(item.path.name for item in request.session.items)
    if LONG_REPLAY not in counts:
        pytest.skip(f"{LONG_REPLAY} is not selected")
    paths = {item.path.name: item.path for item in request.session.items}
    waiting = [name for name, path in sorted(paths.items()) if starts_children(path)]
    late = {name: counts[name] for name in waiting if counts[name] > counts[LONG_REPLAY] or name < LONG_REPLAY}
    assert not late, f"modules that start a JAX child queue ahead of {LONG_REPLAY} ({counts[LONG_REPLAY]}): {late}"
