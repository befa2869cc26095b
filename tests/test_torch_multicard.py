"""The sharded step's order between shards (``parallel/streams.ShardOrder``)
on the CPU, where its streams are None and its record and wait calls do
nothing: a recorder swapped in for those calls replays them as vector
clocks (a shard's clock of another shard: how many of that shard's ops its
stream has waited for) and checks that every read or store across shards
comes after a wait on the writer's mark:

* K12's round k on shard r after r±1's round k−1 (or their K13 priming),
  and K12's and K13's stores into a neighbour's output after everything
  the neighbour did before the call (the caching allocator may have handed
  it memory the neighbour's stream was still using);
* the first launch on r after a K13 call after r±1's K13 launches;
* K10's round k on r after r±1's round k−1;
* K7e on r after everything r±1 did before its halo planes were taken
  (``neighbour_planes``), K10 and K11 after everything r±1 did before the
  exchange that built their slabs (``extend``, ``halo_exchange_z``);
* ``gathered``'s op after every shard's inputs, and each shard's copy-out
  after the op.

With the waits patched away, the same replay finds the reads unordered,
so the check sees a missing wait.  Also here: ``make_mesh`` refuses a mesh
that mixes device types, the CLI's shard → card layout
(``cli.mesh_devices``), and the 4-shard step bitwise the one-shard step.
Everything at 32³ on ``make_mesh(["cpu"] * 4)``.
"""

import contextlib
import json

import pytest
import torch

from fluidsim_tpu_torch import cli
from fluidsim_tpu_torch.kernels import halo as khalo
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.parallel import halo as phalo
from fluidsim_tpu_torch.parallel import step as pstep
from fluidsim_tpu_torch.parallel import (
    make_mesh,
    shard_state,
    sharded_step_fn,
    unshard_state,
)
from fluidsim_tpu_torch.parallel.streams import Mark, ShardOrder, order_for

from test_torch_shards import FIELDS, K, preset, start

torch.set_num_threads(1)


class Recorder:
    """Vector clocks of the shards' streams, replayed from ``ShardOrder``'s
    calls, and a log of the launches and exchanges to check them against."""

    def __init__(self, monkeypatch, waits: bool = True):
        self.clock = {}      # (order id, shard) -> {shard: ops seen}
        self.current = []    # stack of (order, shard) inside on()
        self.log = []
        orig_on = ShardOrder.on
        recorder = self

        @contextlib.contextmanager
        def on(order, r, count=True):
            with orig_on(order, r, count):
                # The op in flight: counted once issued.
                clock = recorder.clock_of(order, r)
                clock[r] = order._ops[r] + 1
                recorder.current.append((order, r))
                try:
                    yield
                finally:
                    recorder.current.pop()

        def record(order, s):
            seen = dict(recorder.clock_of(order, s))
            seen[s] = order._ops[s]
            return Mark(s, order._ops[s], seen)

        def wait(order, r, mark):
            clock = recorder.clock_of(order, r)
            for s, ops in mark.event.items():
                clock[s] = max(clock.get(s, 0), ops)

        monkeypatch.setattr(ShardOrder, "on", on)
        monkeypatch.setattr(ShardOrder, "_record", record)
        monkeypatch.setattr(ShardOrder, "_wait", wait if waits else lambda *a: None)
        for module, name in ((phalo, "extend"), (phalo, "halo_exchange_z"),
                             (pstep, "neighbour_planes"), (khalo, "_shards_round")):
            monkeypatch.setattr(module, name, self.begins(name, getattr(module, name)))
        for name in ("_k12_share_plain", "_k13_share_plain"):
            monkeypatch.setattr(khalo, name, self.launches(name[1:4].upper(),
                                                           getattr(khalo, name)))
        self.kernels = PLAIN_TWINS._replace(**{
            field: self.launches(name, getattr(PLAIN_TWINS, field))
            for field, name in (("jacobi_ext", "K10"), ("advect_ext", "K11"),
                                ("divergence_ext", "K7e div"), ("gradient_ext", "K7e grad"))})

    def clock_of(self, order, r):
        return self.clock.setdefault((id(order), r), {})

    def begins(self, name, fn):
        """``fn`` logging, before it runs, every shard's ops so far."""
        def logged(xs, *args, **kw):
            order = phalo.order_of(xs)
            self.log.append(dict(kind="begin", name=name, ops=list(order._ops)))
            return fn(xs, *args, **kw)
        return logged

    def launches(self, name, fn):
        """``fn`` logging its shard, that shard's ops and its clock."""
        def logged(*args, **kw):
            order, r = self.current[-1]
            self.log.append(dict(kind="launch", name=name, r=r, ops=order._ops[r] + 1,
                                 clock=dict(self.clock_of(order, r)), k=len(order.devices)))
            return fn(*args, **kw)
        return logged

    def unordered(self):
        """Every launch that reads or stores across shards before its stream
        waited on the writer: ``(launch, shard, neighbour, ops needed, ops
        seen)``."""
        bad = []
        last_begin = None
        rounds = {"K12": {}, "K10": {}}  # each shard's ops at its rounds
        pending = {}  # shard -> {neighbour: ops of its K13 launch}
        for entry in self.log:
            if entry["kind"] == "begin":
                last_begin = entry
                continue
            r, name, k = entry["r"], entry["name"], entry["k"]
            nbrs = [s for s in (r - 1, r + 1) if 0 <= s < k]
            needs = {}

            def need(s, ops):
                needs[s] = max(needs.get(s, 0), ops)

            if name == "K13":
                # Its pushes are read by each neighbour's next launch.
                for s in nbrs:
                    pending.setdefault(s, {})[r] = entry["ops"]
            else:
                for s, ops in pending.pop(r, {}).items():
                    need(s, ops)
            if name in rounds:
                # Round j of r reads the planes r±1 pushed, or that its
                # refresh copied, in round j - 1.
                mine = rounds[name].setdefault(r, [])
                for s in nbrs:
                    theirs = rounds[name].get(s, [])
                    if mine and len(theirs) >= len(mine):
                        need(s, theirs[len(mine) - 1])
                mine.append(entry["ops"])
            if name in ("K7e div", "K7e grad", "K10", "K11") and last_begin is not None:
                for s in nbrs:
                    need(s, last_begin["ops"][s])
            if name in ("K12", "K13"):
                # Its stores land in the neighbours' fresh outputs, whose
                # memory their streams may have used until the call began.
                for s in nbrs:
                    need(s, last_begin["ops"][s])
            for s, ops in needs.items():
                seen = entry["clock"].get(s, 0)
                if seen < ops:
                    bad.append((name, r, s, ops, seen))
        return bad


def one_step(backend, t, kernels, dtype="float32"):
    cfg = preset("sharded_512", dtype=dtype)
    mesh = make_mesh(["cpu"] * K)
    step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=t, halo_backend=backend,
                           kernels=kernels)
    return unshard_state(step(shard_state(start(cfg), mesh)))


@pytest.mark.parametrize("backend,t", [("pallas", 2), ("pallas", 4), ("rdma", 2),
                                       ("rdma", 4)])
def test_every_cross_shard_access_waits_on_its_writer(monkeypatch, backend, t):
    """The 4-shard explicit step: each launch that reads or stores across
    shards comes after its stream waited on the writers' marks (the module
    docstring's rules), and the step is bitwise the same step without the
    recorder."""
    ref = one_step(backend, t, PLAIN_TWINS)
    rec = Recorder(monkeypatch)
    got = one_step(backend, t, rec.kernels)
    names = {e["name"] for e in rec.log if e["kind"] == "launch"}
    want = {"K11", "K7e div", "K7e grad"} | ({"K12", "K13"} if backend == "rdma" else {"K10"})
    assert names == want
    rounds = sum(e["name"] in ("K10", "K12") for e in rec.log if e["kind"] == "launch")
    assert rounds == K * preset("sharded_512").jacobi_iters // t
    assert rec.unordered() == []
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_the_check_sees_a_missing_wait(monkeypatch, backend):
    """With every wait patched away, the same replay finds cross-shard
    launches unordered: K7e's halo planes, the exchanges' slabs and, on
    rdma, K12's rounds and K13's outputs."""
    rec = Recorder(monkeypatch, waits=False)
    one_step(backend, 4, rec.kernels)
    bad = {name for name, *_ in rec.unordered()}
    assert {"K7e div", "K7e grad", "K11"} <= bad
    assert ({"K12"} if backend == "rdma" else {"K10"}) <= bad


def test_gathered_waits_on_every_shard(monkeypatch):
    """``gathered``'s op runs on the first shard of the device after waiting
    on every shard's writes, and each shard copies its planes out after
    waiting on the op."""
    rec = Recorder(monkeypatch)
    order = order_for(["cpu"] * K)
    xs, made = [], []
    for r in range(K):
        with order.on(r):
            xs.append(torch.full((2, 4, 4), float(r)))
        made.append(order._ops[r])
    seen_at_op = {}
    read = []
    orig_fetch = ShardOrder.fetch

    def fetch(self, x, r):
        read.append((r, dict(rec.clock_of(self, r))))
        return orig_fetch(self, x, r)

    monkeypatch.setattr(ShardOrder, "fetch", fetch)

    def fn(x):
        o, r0 = rec.current[-1]
        seen_at_op.update(r0=r0, clock=dict(rec.clock_of(o, r0)), ops=o._ops[r0] + 1)
        return (x * 2.0,)

    out = phalo.gathered("test", fn, [xs], (0,), (0,), [torch.device("cpu")] * K)
    assert seen_at_op["r0"] == 0
    for s in range(1, K):
        assert seen_at_op["clock"][s] >= made[s], s
    # The copy-outs: the last K fetches, one a shard, after the op.
    for r, clock in read[-K:]:
        assert r == 0 or clock[0] >= seen_at_op["ops"], r
    for r in range(K):
        assert torch.equal(out[r][0], torch.full((2, 4, 4), 2.0 * r))


def test_make_mesh_refuses_mixed_device_types():
    """A mesh is all CPU or all CUDA: mixing types raises; the CPU mesh has
    no streams and shares its order with every list of shards on the same
    devices."""
    with pytest.raises(ValueError, match="mixes device types"):
        make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="mixes device types"):
        make_mesh(["cpu"] * 3 + ["meta"])
    mesh = make_mesh(["cpu"] * K)
    assert mesh.streams == (None,) * K
    assert mesh.order is order_for([torch.device("cpu")] * K)
    assert phalo.order_of([torch.zeros(1)] * K) is mesh.order


def test_scope_orders_only_at_its_outermost_level():
    """Marks are recorded only for shards given work since their last mark;
    a nested scope leaves the order to the outermost one."""
    order = order_for(["cpu"] * 2)
    marks = order.marks()
    with order.scope():
        with order.scope():
            assert order._depth == 2
        assert order._depth == 1
        with order.on(1):
            pass
        with order.on(0, count=False):
            pass
        again = order.marks()
    assert order._depth == 0
    assert again[0] is marks[0] and again[1] is not marks[1]
    assert again[1].ops == marks[1].ops + 1
    # An op counts once issued: a mark inside it leaves it to the next.
    with order.on(0):
        inside = order.marks()
    after = order.marks()
    assert inside[0].ops == again[0].ops and after[0].ops == again[0].ops + 1


@pytest.mark.parametrize("cards,want", [(1, [0] * 8), (2, [0, 0, 0, 0, 1, 1, 1, 1]),
                                        (4, [0, 0, 1, 1, 2, 2, 3, 3]),
                                        (8, list(range(8))), (16, list(range(8)))])
def test_cli_puts_shard_r_on_card_r_d_over_n(cards, want):
    """``bench --mesh 8`` on D = min(8, visible cards) cards: shard r on card
    ⌊r·D/8⌋."""
    assert cli.mesh_devices(8, cards) == want


@pytest.mark.parametrize("shards,cards", [(8, 3), (8, 5), (6, 4)])
def test_cli_refuses_a_mesh_that_does_not_split_over_the_cards(monkeypatch, capsys, shards,
                                                                cards):
    """N % D != 0: an error line and exit code 1, as the JAX CLI when it
    lacks devices."""
    with pytest.raises(ValueError, match="do not split evenly"):
        cli.mesh_devices(shards, cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    rc = cli.main(["bench", "--preset", "sharded512", "--mesh", str(shards), "--halo",
                   "explicit", "--halo-block-iters", "4", "--steps", "1"])
    assert rc == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "do not split evenly" in line["error"]


@pytest.mark.parametrize("backend,t", [("pallas", 2), ("rdma", 4)])
def test_4_shard_step_is_the_one_shard_step(backend, t):
    """Two explicit steps on 4 shards, each on its own (CPU) queue, bitwise
    the same steps on a one-shard mesh, the unsharded volume."""
    cfg = preset("sharded_512")
    got = {}
    for shards in (K, 1):
        mesh = make_mesh(["cpu"] * shards)
        step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=t,
                               halo_backend=backend)
        st = shard_state(start(cfg), mesh)
        got[shards] = unshard_state(step(step(st)))
    for f in FIELDS + ("step", "time"):
        assert torch.equal(getattr(got[K], f), getattr(got[1], f)), f
