"""The shardkv service layer in its schedule mode (``tpusim/shardkv.py``)
against the live JAX package's ``madraft_tpu.tpusim.shardkv``, tick by
tick, on the CPU.

The same seed, configs and threefry counter layout go through the JAX
``shardkv_step`` (vmapped, jitted, its knobs passed as arguments so that
the cases of one static shape share one compile) and the port's
``shardkv_step`` (the eager route: ``step_cluster`` over the B x G group
clusters, then K11's plain version). Every ``ShardKvState`` leaf, the
group rafts' and the placeholder controller's included, is compared
after every tick (``shardkv.first_divergence``). The CLI's storm with
``cfg_interval`` 16 lands all five reconfigurations, their pulls,
installs and GCs within the run's 120 ticks. The kinds (clean, each
planted bug, Puts, open-loop Zipf traffic, the WrongGroup re-query) run
side by side as [B] knob rows, 42 deployments, with metrics off and on,
here at n = 3 under the partitionable layout; ``ShardKvPair``,
``check_rows`` and ``check_uniform`` (a config's 0-d knobs: the port's
uniform path) serve ``test_torch_shardkv_bugs.py`` (n = 5, legacy).
Tolerance: exact equality."""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import shardkv as jsk
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg

# the CLI's storm shape (cap 64, compact_every 16)
BASE = dict(p_client_cmd=0.0, compact_at_commit=False, log_cap=64,
            compact_every=16, loss_prob=0.1, p_crash=0.01, p_restart=0.2,
            max_dead=1)
SKV = dict(cfg_interval=16)
TICKS = 120
# the kinds, deployment d running kind d % 7 as its knob row
# (chip_smoke.shardkv_knob_rows), and the violation bit each bug sets
KINDS = chip_smoke.SHARDKV_ROW_CASES
BUG_BITS = {"skip_freeze": psk.VIOLATION_SHARD_DIVERGE,
            "drop_dup_table": psk.VIOLATION_SHARD_DIVERGE,
            "serve_frozen": psk.VIOLATION_SHARD_STALE_READ}
# (the uniform runs take the rows' batch size: one compiled program)
DEPLOYMENTS = 42


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg, jkcfg, partitionable: bool):
    # the shardkv knobs are [B] row arguments, so every case of one static
    # shape shares a program (the layout is read while tracing)
    init = jax.jit(jax.vmap(functools.partial(jsk.init_shardkv_cluster, jcfg,
                                              jkcfg), in_axes=(0, None, 0)))
    step = jax.jit(jax.vmap(functools.partial(jsk.shardkv_step, jcfg, jkcfg),
                            in_axes=(0, 0, None, 0)))
    return init, step


def jax_flat(st) -> dict:
    """A JAX shardkv state as the port's flat field -> numpy mapping."""
    out = {f"rafts.{f}": np.array(getattr(st.rafts, f))
           for f in st.rafts._fields}
    out.update({f"ctrl.{f}": np.array(getattr(st.ctrl, f))
                for f in st.ctrl._fields})
    out.update({f: np.array(getattr(st, f)) for f in psk.SERVICE})
    return out


class ShardKvPair:
    """The reference and the port stepping the same batch of deployments.
    With ``rows`` deployment d runs kind d % 7 as a [B] knob row on both
    sides; without, the port runs the config's 0-d knobs and the
    reference the same values as rows (one program for both)."""

    def __init__(self, kw: dict, n: int, metrics: bool, b: int, seed: int,
                 rows: bool = False):
        kw = {**SKV, **kw}
        self.jcfg = JaxCfg(n_nodes=n, metrics=metrics, **BASE)
        self.pcfg = PortCfg(n_nodes=n, metrics=metrics, **BASE)
        self.jk, self.pk = jsk.ShardKvConfig(**kw), psk.ShardKvConfig(**kw)
        init, self._jstep = _jax_programs(self.jcfg.static_key(),
                                          self.jk.static_key(),
                                          prng.partitionable())
        self.jkeys = jengine._cluster_keys(jnp.uint32(seed), b)
        self.pkeys = pengine.cluster_keys(seed, b, "cpu")
        self.jkn, self.pkn = self.jcfg.knobs(), self.pcfg.knobs("cpu")
        self.pskn = (chip_smoke.shardkv_knob_rows(self.pk, b) if rows
                     else self.pk.knobs("cpu"))
        self.jskn = jsk.ShardKvKnobs(*(
            jnp.asarray(x.expand(b).numpy()) for x in self.pskn))
        self.js = init(self.jkeys, self.jkn, self.jskn)
        self.ps = psk.init_shardkv_cluster(self.pcfg, self.pk, self.pkeys,
                                           self.pkn, self.pskn)
        self.gkeys = psk.group_keys(self.pkeys, self.pk.n_groups).reshape(-1, 2)
        self.tick = 0

    def divergence(self):
        return psk.first_divergence(self.tick, jax_flat(self.js),
                                    psk.shardkv_state_to_numpy(self.ps))

    def run(self, ticks: int):
        """Step both sides, every leaf compared after every tick; the
        first divergence or None."""
        d = self.divergence()
        for _ in range(ticks):
            if d is not None:
                return d
            self.js = self._jstep(self.js, self.jkeys, self.jkn, self.jskn)
            self.ps = psk.shardkv_step(self.pcfg, self.pk, self.ps,
                                       self.pkeys, self.pkn, self.pskn,
                                       gkeys=self.gkeys)
            self.tick += 1
            d = self.divergence()
        return d


def check_rows(n: int, metrics: bool, seed: int):
    """Every kind of KINDS as knob rows on both sides: every leaf equal
    after every tick (the violation bits and first violation ticks among
    them); the batch walks the whole schedule; every kind acks ops, and
    every kind but skip_freeze installs and GCs shards; each bug's oracle
    fires on some of its deployments, and no clean kind's deployment
    violates."""
    pair = ShardKvPair({}, n, metrics, DEPLOYMENTS, seed, rows=True)
    d = pair.run(TICKS)
    assert d is None, d
    final = pair.js
    kind = np.arange(DEPLOYMENTS) % len(KINDS)
    viol = np.asarray(final.violations)
    acked = np.asarray(final.clerk_acked).sum(-1)
    for i, name in enumerate(KINDS):
        m = kind == i
        assert acked[m].sum() > 0, name
        if name != "skip_freeze":
            assert np.asarray(final.installs_done)[m].sum() > 0, name
            assert np.asarray(final.deletes_done)[m].sum() > 0, name
        bit = BUG_BITS.get(name, 0)
        if bit:
            assert (viol[m] & bit).any(), f"{name}: the oracle never fired"
        else:
            assert not viol[m].any(), f"{name} violated: {viol[m]}"
    assert np.asarray(final.w_cfg).max() == pair.pk.n_configs - 1
    if metrics:
        assert np.asarray(final.lat_hist).sum() > 0
    assert np.asarray(final.open_srv)[kind == KINDS.index("open_zipf")].sum()
    return pair


def check_uniform(kw: dict, n: int, metrics: bool, seed: int, bit: int):
    """One config's 0-d knobs on the port (the reference: the same values
    as rows, one program for both): every leaf equal after every tick,
    the whole schedule walked, the bit fired (or none, with bit 0)."""
    pair = ShardKvPair(kw, n, metrics, DEPLOYMENTS, seed)
    d = pair.run(TICKS)
    assert d is None, d
    final = pair.js
    viol = np.asarray(final.violations)
    assert np.asarray(final.clerk_acked).sum() > 0
    assert np.asarray(final.installs_done).sum() > 0
    assert np.asarray(final.w_cfg).max() == pair.pk.n_configs - 1
    assert (viol & bit).any() if bit else not viol.any(), viol
    return pair


@pytest.mark.parametrize("metrics", [False, True])
def test_shardkv_kinds_equal_the_reference_every_tick(metrics):
    with threefry_layout(True):
        check_rows(3, metrics, 6)
