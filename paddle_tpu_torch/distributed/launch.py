"""python -m paddle_tpu_torch.distributed.launch — the training entry
point (counterpart of ``paddle_tpu/distributed/launch.py``).

    python -m paddle_tpu_torch.distributed.launch train.py --lr 0.1
    python -m paddle_tpu_torch.distributed.launch --nproc-per-node 4 \\
        train.py ...
    python -m paddle_tpu_torch.distributed.launch --coordinator H:P \\
        --nnodes 2 --node-rank 0 train.py ...
    python -m paddle_tpu_torch.distributed.launch --elastic 3 \\
        [--heartbeat-file HB --heartbeat-timeout S] train.py ...

One process drives one card (the reference runs one process a host over
every chip).  ``--nproc-per-node`` (default: the visible cards, at
least 1) workers start on this node through
``distributed.utils.start_local_trainers``, each with its rank, the
world, the endpoints and its card in its environment
(``FLAGS_selected_gpus``); the launcher watches them, and the first
failure ends them all.  ``--coordinator host:port`` with ``--nnodes``
and ``--node-rank`` is the multi-node rendezvous in place of the
reference's ``jax.distributed.initialize``: ranks are node-major, and
the workers meet at ``tcp://host:port`` (``MASTER_ADDR``/``MASTER_PORT``)
when they call ``fleet.init`` or ``init_parallel_env``.  One worker
without a coordinator runs the script in this process.

``--elastic N`` supervises one worker (``distributed.elastic.
supervise``): the launcher re-executes itself without ``--elastic`` as
the worker and restarts it up to N times on failure, for free after a
preemption (exit code 117), and kills it when its heartbeat file goes
stale.  The worker learns the heartbeat path from
``PADDLE_TPU_HEARTBEAT_FILE`` (``auto_checkpoint`` touches it at every
save).
"""
import argparse
import os
import runpy
import sys

__all__ = ['launch_main']


def _visible_cards():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _cluster(args, nproc):
    """``(cluster, this node's pod)`` for ``nproc`` workers a node."""
    from .utils import find_free_ports, get_cluster
    devices = list(range(nproc))
    if args.coordinator is not None:
        ips = [f'node{i}' for i in range(args.nnodes)]
        ips[0] = args.coordinator.rsplit(':', 1)[0]
        port = int(args.coordinator.rsplit(':', 1)[1])
        eps = [[f'{ip}:{port + j}' for j in range(nproc)] for ip in ips]
        eps[0][0] = args.coordinator
        return get_cluster(ips, ips[args.node_rank], eps, devices)
    ports = sorted(find_free_ports(nproc) or [])
    if len(ports) < nproc:
        raise RuntimeError(f'could not reserve {nproc} free ports')
    eps = [[f'127.0.0.1:{p}' for p in ports]]
    return get_cluster(['127.0.0.1'], '127.0.0.1', eps, devices)


def launch_main(argv=None):
    ap = argparse.ArgumentParser(
        prog='paddle_tpu_torch.distributed.launch',
        description='Run a training script, one worker per card, '
                    'optionally under elastic supervision.')
    ap.add_argument('--coordinator', default=None,
                    help='host:port of the multi-node rendezvous (node '
                         '0\'s first worker listens there)')
    ap.add_argument('--nnodes', type=int, default=None,
                    help='number of nodes')
    ap.add_argument('--node-rank', type=int, default=None,
                    help='this node\'s index in [0, nnodes)')
    ap.add_argument('--nproc-per-node', type=int, default=None,
                    help='workers on this node, one a card (default: the '
                         'visible cards, at least 1)')
    ap.add_argument('--elastic', type=int, default=None,
                    metavar='MAX_RESTARTS',
                    help='supervise the worker: restart it up to '
                         'MAX_RESTARTS times on failure; pair with '
                         'incubate.checkpoint.auto_checkpoint or '
                         'ParallelTrainer.restore_checkpoint so the '
                         'restarted worker resumes from the last '
                         'checkpoint')
    ap.add_argument('--elastic-log-dir', default=None,
                    help='worker log dir in elastic mode')
    ap.add_argument('--heartbeat-file', default=None,
                    help='worker heartbeat file; a stale mtime beyond '
                         '--heartbeat-timeout restarts the worker')
    ap.add_argument('--heartbeat-timeout', type=float, default=None)
    ap.add_argument('script', help='training script to run')
    ap.add_argument('script_args', nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    # usage errors must fail HERE, not burn the elastic restart budget
    # on a worker that exits 2 every incarnation
    if args.coordinator is not None and (args.nnodes is None
                                         or args.node_rank is None):
        ap.error('--coordinator requires --nnodes and --node-rank')
    if args.coordinator is not None and ':' not in args.coordinator:
        ap.error('--coordinator is host:port')
    if (args.heartbeat_file is None) != (args.heartbeat_timeout is None):
        ap.error('--heartbeat-file and --heartbeat-timeout must be '
                 'passed together')
    nproc = args.nproc_per_node or max(1, _visible_cards())
    if args.elastic is not None and (nproc > 1 or args.coordinator):
        ap.error('--elastic supervises one worker on one node')
    if not os.path.isfile(args.script):
        ap.error(f'no training script {args.script!r}')

    if args.elastic is not None:
        from .elastic import supervise
        cmd = [sys.executable, '-u', '-m',
               'paddle_tpu_torch.distributed.launch',
               args.script] + args.script_args
        if args.heartbeat_file is not None:
            # the worker must KNOW the heartbeat path or it can never
            # touch it and the supervisor would kill a healthy worker
            # every heartbeat_timeout
            os.environ['PADDLE_TPU_HEARTBEAT_FILE'] = args.heartbeat_file
        rc = supervise(cmd, max_restarts=args.elastic,
                       log_dir=args.elastic_log_dir,
                       heartbeat_file=args.heartbeat_file,
                       heartbeat_timeout=args.heartbeat_timeout)
        sys.exit(rc)

    if nproc == 1 and args.coordinator is None:
        sys.argv = [args.script] + args.script_args
        runpy.run_path(args.script, run_name='__main__')
        return
    from .utils import _trainer_env, run_local_trainers, start_local_trainers
    cluster, pod = _cluster(args, nproc)
    if nproc == 1:
        # one worker on this node: it runs here, in the world's place
        os.environ.update(_trainer_env(cluster, pod.trainers[0]))
        sys.argv = [args.script] + args.script_args
        runpy.run_path(args.script, run_name='__main__')
        return
    procs = start_local_trainers(cluster, pod, args.script,
                                 args.script_args)
    try:
        run_local_trainers(procs, cluster.trainers_nranks())
    except RuntimeError as e:
        print(f'launch: {e}', file=sys.stderr)
        sys.exit(1)


if __name__ == '__main__':
    launch_main()
