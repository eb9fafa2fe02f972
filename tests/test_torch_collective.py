"""The port's collectives (``paddle_tpu_torch.distributed.collective``)
in a world of 4 gloo processes on the CPU, against the JAX package's
collectives inside ``shard_map`` over the same mesh on 4 of the 8
virtual CPU devices.

One launch of 4 workers (``tests/torch_dist_worker.py``, the
``collectives`` job) runs every collective on the world group (a 1-D
JAX mesh of 4), then on the ``dp`` and ``tp`` groups of a 2 x 2 mesh
(the JAX mesh ``{'dp': 2, 'tp': 2}``, rank ``2 dp + tp`` on both sides)
and on a group spanning both axes; the parametrised cases read its
results.  Rank ``r``'s tensor is ``arange + 10 r + 1``.  f32, exact.
A world of one process is the identity, as the reference's collectives
are outside a parallel region.  A worker that never reaches a barrier
fails its launch within the launch's own wall-clock limit, and no
worker is left running.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as jpaddle
from paddle_tpu.core.jaxcompat import shard_map
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import collective as jcol
from paddle_tpu.distributed import env as jenv
import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import collective

import torch_dist_worker as worker

OPS = ['all_reduce_SUM', 'all_reduce_MAX', 'all_reduce_MIN',
       'all_reduce_PROD', 'all_reduce_AVG', 'all_gather', 'all_gather_list',
       'all_gather_axis1', 'broadcast', 'reduce', 'scatter', 'alltoall',
       'p2p', 'send', 'recv', 'recv_dst', 'rotate', 'wait']
GROUPS = {'world': ((4,), ('w',), ('w',)),
          'dp': ((2, 2), ('dp', 'tp'), ('dp',)),
          'tp': ((2, 2), ('dp', 'tp'), ('tp',))}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    """The 4 workers' results (one launch for the module) and the JAX
    results, computed while the workers run."""
    job = worker.start([('c', 'collectives', {})],
                       tmp_path_factory.mktemp('collective'), nproc=4,
                       timeout=90)
    try:
        want = {tag: _jax_results(*args) for tag, args in GROUPS.items()}
    finally:
        out = job.wait()
    return [r['c'] for r in out], want


@pytest.fixture(scope='module')
def runs(launched):
    return launched[0]


@pytest.fixture(scope='module')
def oracle(launched):
    return launched[1]


def _base(rank, shape=(3,)):
    return np.arange(int(np.prod(shape)), dtype=np.float32) \
        .reshape(shape) + 10.0 * rank + 1.0


def _jax_results(shape, names, axes):
    """Each op of ``OPS`` through the reference's collectives inside
    ``shard_map``, for every rank: ``{op: [4, ...]}``."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)
    jenv.set_mesh(mesh)
    n = int(np.prod([dict(zip(names, shape))[a] for a in axes]))
    spec = P(names)

    def body(x1, x2, lists):
        x1, x2, lists = x1[0], x2[0], lists[0]

        def t(v):
            return JaxTensor._from_value(v)
        with jcol.axis_scope(*names):
            g = jcol.new_group(axes=axes)
            out = {}
            for op in ('SUM', 'MAX', 'MIN', 'PROD', 'AVG'):
                out[f'all_reduce_{op}'] = jcol.all_reduce(
                    t(x1), getattr(jcol.ReduceOp, op), g).value
            parts = []
            out['all_gather'] = jcol.all_gather(parts, t(x2), g).value
            out['all_gather_list'] = jnp.stack([p.value for p in parts])
            out['all_gather_axis1'] = jcol.all_gather([], t(x2), g,
                                                      axis=1).value
            out['broadcast'] = jcol.broadcast(t(x1), 1, g).value
            out['reduce'] = jcol.reduce(t(x1), 1, jcol.ReduceOp.SUM,
                                        g).value
            out['scatter'] = jcol.scatter(
                t(jnp.zeros(3)), [t(x1 * (i + 1)) for i in range(n)], 1,
                g).value
            out['alltoall'] = jnp.stack([
                o.value for o in jcol.alltoall(
                    [t(lists[i]) for i in range(n)], None, g)])
            out['p2p'] = jcol.p2p(t(x1), 1, 0, g).value
            out['send'] = jcol.send(t(x1), 0, g, src=1).value
            out['recv'] = jcol.recv(t(x1), 1, g).value
            out['recv_dst'] = jcol.recv(t(x1), 1, g, dst=0).value
            out['rotate'] = jcol.p2p_rotate(t(x1), g, 1).value
            out['wait'] = jcol.wait(t(x1)).value
        return {k: v[None] for k, v in out.items()}

    x1 = np.stack([_base(r) for r in range(4)])
    x2 = np.stack([_base(r, (2, 3)) for r in range(4)])
    lists = np.stack([np.stack([_base(r) + 100 * i for i in range(n)])
                      for r in range(4)])
    try:
        got = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                        out_specs=spec)(x1, x2, lists)
    finally:
        jenv.set_mesh(None)
    return {k: np.asarray(v) for k, v in got.items()}


@pytest.mark.parametrize('tag', list(GROUPS))
@pytest.mark.parametrize('op', OPS)
def test_collective_matches_the_jax_shard_map(runs, oracle, tag, op):
    for rank in range(4):
        np.testing.assert_array_equal(runs[rank][f'{tag}/{op}'],
                                      oracle[tag][op][rank],
                                      err_msg=f'{tag} {op} rank {rank}')


@pytest.mark.parametrize('tag,ranks', [
    ('world', [[0, 1, 2, 3]] * 4),
    ('dp', [[0, 2], [1, 3], [0, 2], [1, 3]]),
    ('tp', [[0, 1], [0, 1], [2, 3], [2, 3]]),
    ('both', [[0, 1, 2, 3]] * 4)])
def test_groups_follow_the_mesh_with_tp_innermost(runs, tag, ranks):
    for rank in range(4):
        got_ranks, me, n = runs[rank][f'{tag}/group']
        assert got_ranks == ranks[rank]
        assert (me, n) == (ranks[rank].index(rank), len(ranks[rank]))
        assert runs[rank][f'{tag}/all_gather_object'] == [
            {'rank': r} for r in ranks[rank]]


def test_a_group_over_both_axes_reduces_over_the_world(runs, oracle):
    for rank in range(4):
        np.testing.assert_array_equal(runs[rank]['both/all_reduce_SUM'],
                                      oracle['world']['all_reduce_SUM'][rank])
        np.testing.assert_array_equal(runs[rank]['both/all_gather'],
                                      oracle['world']['all_gather'][rank])


def test_rank_lists_rotations_and_coordinates(runs):
    want02 = _base(0) + _base(2)
    for rank in range(4):
        r = runs[rank]
        assert r['axis_rank'] == (rank // 2, rank % 2)
        np.testing.assert_array_equal(r['rotate2'], _base((rank - 2) % 4))
        assert ('ranks02' in r) == (rank in (0, 2))
        if rank in (0, 2):
            np.testing.assert_array_equal(r['ranks02'], want02)
        assert r['staged'] is True       # gloo stages a CUDA tensor


def test_all_reduce_identity_outside():
    """No process group: a world of one, every collective the identity
    (the reference's outside a ``shard_map`` region)."""
    assert not torch.distributed.is_initialized()
    t = torch.tensor([1.0, 2.0])
    for fn in (lambda: paddle.distributed.all_reduce(t),
               lambda: paddle.distributed.broadcast(t, 0),
               lambda: paddle.distributed.reduce(t, 0),
               lambda: collective.p2p_rotate(t),
               lambda: paddle.distributed.recv(t, 0)):
        assert fn() is t
        assert t.tolist() == [1.0, 2.0]
    parts = []
    assert paddle.distributed.all_gather(parts, t).tolist() == [1.0, 2.0]
    assert len(parts) == 1
    assert paddle.distributed.all_gather_object([], 'x') == ['x']
    assert collective.get_axis_rank('dp') == 0
    assert collective.get_group(0).ranks == [0]
    paddle.distributed.barrier()
    j = jpaddle.to_tensor([1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(jcol.all_reduce(j).value),
                                  t.numpy())


def test_a_hung_worker_fails_its_launch_in_time(tmp_path):
    """Rank 1 sleeps past the launch's limit: the launch raises within
    it, and both workers are gone."""
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='still running'):
        worker.launch([('h', 'hang', {'seconds': 300})], tmp_path,
                      nproc=2, timeout=8)
    assert time.monotonic() - t0 < 30
    for r in range(2):
        pid = int((tmp_path / f'pid{r}').read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
