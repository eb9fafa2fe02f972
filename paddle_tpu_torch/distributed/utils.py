"""Launch topology utilities (counterpart of
``paddle_tpu/distributed/utils.py``): the ``Cluster``/``Pod``/``Trainer``
containers, ``get_cluster``, ``find_free_ports`` and the local trainer
processes (``start_local_trainers``, ``watch_local_trainers``,
``terminate_local_procs``, shared with ``distributed.elastic``).

A trainer is one process driving one card: its environment names its
rank, the world, the endpoints, the rendezvous (``MASTER_ADDR``/
``MASTER_PORT``, the first trainer's endpoint, for ``torch.distributed``'s
``env://``) and its card (``FLAGS_selected_gpus`` and
``CUDA_VISIBLE_DEVICES`` left as they are, so every card stays
visible), which ``distributed.init_parallel_env`` reads.
"""
import logging
import os
import socket
import subprocess
import sys
import time

from . import elastic as _elastic

__all__ = [
    'get_host_name_ip', 'Trainer', 'get_cluster', 'start_local_trainers',
    'watch_local_trainers', 'find_free_ports', 'JobServer', 'Cluster',
    'Pod', 'Hdfs', 'add_arguments', 'terminate_local_procs',
    'TrainerProc', 'get_logger', 'pull_worker_log', 'run_local_trainers']

logger = logging.getLogger('paddle_tpu_torch.distributed')


def get_logger(log_level=20, name='root'):
    """A logger with one stream handler."""
    lg = logging.getLogger(name)
    lg.setLevel(log_level)
    if not lg.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            '%(asctime)s-%(levelname)s: %(message)s'))
        lg.addHandler(h)
    return lg


class Hdfs:
    """Checkpoint-store coordinates, kept as a plain record."""

    def __init__(self):
        self.hdfs_ugi = None
        self.hdfs_name = None
        self.hdfs_path = None

    def is_valid(self):
        return None not in (self.hdfs_ugi, self.hdfs_name, self.hdfs_path)

    def __eq__(self, o):
        return (self.hdfs_ugi, self.hdfs_name, self.hdfs_path) == \
            (o.hdfs_ugi, o.hdfs_name, o.hdfs_path)

    def __ne__(self, o):
        return not self == o

    def __str__(self):
        return (f'hdfs_ugi:{self.hdfs_ugi} hdfs_name:{self.hdfs_name} '
                f'hdfs_path:{self.hdfs_path}')


class JobServer:
    def __init__(self):
        self.endpoint = None

    def __eq__(self, o):
        return self.endpoint == o.endpoint

    def __ne__(self, o):
        return not self == o

    def __str__(self):
        return str(self.endpoint)


class Trainer:
    """One worker process: its card(s), endpoint and global rank."""

    def __init__(self):
        self.accelerators = []
        self.endpoint = None
        self.rank = None

    @property
    def gpus(self):
        return self.accelerators

    def __eq__(self, t):
        return (self.accelerators == t.accelerators
                and self.endpoint == t.endpoint and self.rank == t.rank)

    def __ne__(self, t):
        return not self == t

    def __str__(self):
        return (f'accelerators:{self.accelerators} '
                f'endpoint:{self.endpoint} rank:{self.rank}')


class Pod:
    """One host: its address, port and trainers."""

    def __init__(self):
        self.rank = None
        self.id = None
        self.addr = None
        self.port = None
        self.trainers = []
        self.accelerators = []

    @property
    def gpus(self):
        return self.accelerators

    def __eq__(self, pod):
        return (self.rank == pod.rank and self.id == pod.id
                and self.addr == pod.addr and self.port == pod.port
                and self.trainers == pod.trainers)

    def __ne__(self, pod):
        return not self == pod

    def get_visible_accelerators(self):
        if not self.accelerators:
            raise ValueError(f'pod {self} sees no accelerators')
        return ','.join(str(g) for g in self.accelerators)

    get_visible_gpus = get_visible_accelerators

    def __str__(self):
        return (f'rank:{self.rank} id:{self.id} addr:{self.addr} '
                f'port:{self.port} accelerators:{self.accelerators} '
                f'trainers:{[str(t) for t in self.trainers]}')


class Cluster:
    """All pods of one job."""

    def __init__(self, hdfs=None):
        self.job_server = None
        self.pods = []
        self.hdfs = hdfs
        self.job_stage_flag = None

    def __eq__(self, c):
        return (self.pods == c.pods
                and self.job_stage_flag == c.job_stage_flag)

    def __ne__(self, c):
        return not self == c

    def update_pods(self, cluster):
        self.pods = list(cluster.pods)

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def pods_nranks(self):
        return len(self.pods)

    def trainers_endpoints(self):
        return [t.endpoint for pod in self.pods for t in pod.trainers]

    def pods_endpoints(self):
        eps = []
        for pod in self.pods:
            if pod.addr is None or pod.port is None:
                raise ValueError(f'{pod.addr}:{pod.port} is not a valid '
                                 'endpoint')
            eps.append(f'{pod.addr}:{pod.port}')
        return eps

    def get_pod_by_id(self, pod_id):
        for pod in self.pods:
            if str(pod.id) == str(pod_id):
                return pod
        return None

    def __str__(self):
        return (f'job_server:{self.job_server} '
                f'pods:{[str(p) for p in self.pods]} '
                f'job_stage_flag:{self.job_stage_flag} hdfs:{self.hdfs}')


def get_cluster(node_ips, node_ip, trainer_endpoints, selected_devices):
    """``(cluster, this node's pod)``: one pod a node, one trainer a
    selected card, ranks node-major.  ``trainer_endpoints`` is one list
    of endpoints a node."""
    if not isinstance(trainer_endpoints, list):
        raise TypeError('trainer_endpoints must be a list (one list of '
                        'endpoints per node)')
    cluster = Cluster()
    rank = 0
    for node_rank, ip in enumerate(node_ips):
        pod = Pod()
        pod.rank = node_rank
        pod.id = node_rank
        pod.addr = ip
        pod.accelerators = list(selected_devices)
        eps = trainer_endpoints[node_rank]
        if len(eps) < len(selected_devices):
            raise ValueError(
                f'node {ip} has {len(eps)} endpoints for '
                f'{len(selected_devices)} selected devices')
        for dev, ep in zip(selected_devices, eps):
            t = Trainer()
            t.accelerators.append(dev)
            t.endpoint = ep
            t.rank = rank
            rank += 1
            pod.trainers.append(t)
        cluster.pods.append(pod)
    return cluster, cluster.pods[node_ips.index(node_ip)]


def get_host_name_ip():
    try:
        name = socket.gethostname()
        return name, socket.gethostbyname(name)
    except OSError:
        return None


def find_free_ports(num):
    """``num`` distinct free TCP ports on this host, or None."""
    ports = set()
    socks = []
    try:
        for _ in range(num * 4):
            if len(ports) >= num:
                break
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(('', 0))
            p = s.getsockname()[1]
            if p not in ports:
                ports.add(p)
                socks.append(s)   # held open so the next bind differs
            else:
                s.close()
    finally:
        for s in socks:
            s.close()
    return ports if len(ports) >= num else None


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """An argparse option; booleans take true/false strings."""
    bool_t = (lambda v: str(v).lower() == 'true') if type == bool else type
    argparser.add_argument('--' + argname, default=default, type=bool_t,
                           help=help + ' Default: %(default)s.', **kwargs)


TrainerProc = _elastic.TrainerProc


def _trainer_env(cluster, trainer, local_rank=0):
    """The environment of one trainer (module docstring)."""
    endpoints = cluster.trainers_endpoints()
    addr, port = endpoints[0].rsplit(':', 1)
    return {
        'PADDLE_TRAINER_ID': str(trainer.rank),
        'PADDLE_RANK_IN_NODE': str(local_rank),
        'PADDLE_CURRENT_ENDPOINT': str(trainer.endpoint),
        'PADDLE_TRAINERS_NUM': str(cluster.trainers_nranks()),
        'PADDLE_TRAINER_ENDPOINTS': ','.join(endpoints),
        'MASTER_ADDR': addr,
        'MASTER_PORT': port,
        'FLAGS_selected_gpus': ','.join(str(g)
                                        for g in trainer.accelerators),
    }


def start_local_trainers(cluster, pod, training_script,
                         training_script_args, log_dir=None, env=None):
    """Spawn this pod's trainers, each with its environment (over
    ``env``, default this process's)."""
    procs = []
    for local_rank, t in enumerate(pod.trainers):
        tenv = dict(os.environ if env is None else env)
        tenv.pop('http_proxy', None)
        tenv.pop('https_proxy', None)
        tenv.update(_trainer_env(cluster, t, local_rank))
        cmd = [sys.executable, '-u', training_script] \
            + list(training_script_args)
        tp = TrainerProc()
        tp.rank = t.rank
        tp.local_rank = local_rank
        tp.cmd = cmd
        tp.env = tenv
        fn = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            fn = open(os.path.join(log_dir, f'workerlog.{local_rank}'),
                      'ab')
        tp.log_fn = fn
        tp.log_offset = fn.tell() if fn else None
        tp.proc = subprocess.Popen(cmd, env=tenv, stdout=fn or None,
                                   stderr=subprocess.STDOUT if fn else None)
        procs.append(tp)
    return procs


def pull_worker_log(tp):
    """Copy a worker's new log lines to stdout."""
    if not tp.log_fn or tp.log_fn.closed:
        return
    tp.log_fn.flush()
    with open(tp.log_fn.name, 'rb') as f:
        f.seek(tp.log_offset or 0)
        chunk = f.read()
        tp.log_offset = f.tell()
    if chunk:
        sys.stdout.write(chunk.decode('utf-8', 'replace'))


def watch_local_trainers(procs, nranks):
    """One poll of the pod's trainers: the ones still running ([] when
    all ended cleanly); the first failure terminates every trainer and
    raises."""
    alive = []
    failed = []
    for tp in procs:
        if tp.log_fn is not None and tp.local_rank == 0:
            pull_worker_log(tp)
        ret = tp.proc.poll()
        if ret is None:
            alive.append(tp)
        else:
            if tp.log_fn is not None and not tp.log_fn.closed:
                tp.log_fn.close()
            if ret != 0:
                failed.append(tp.rank)
    if failed:
        terminate_local_procs(procs)
        raise RuntimeError(
            f'trainer ranks {failed} exited abnormally '
            f'({nranks} total); local trainers terminated')
    return alive


def terminate_local_procs(procs, grace=3.0):
    """SIGTERM, a grace wait, then SIGKILL (``distributed.elastic``'s)."""
    _elastic.terminate_local_procs(procs, grace=grace)


def run_local_trainers(procs, nranks, timeout=None, poll=0.1):
    """Watch ``procs`` until they all end; raises ``RuntimeError`` on a
    failure, and ``TimeoutError`` after ``timeout`` seconds of wall
    time, each after terminating every trainer, so no process is left
    behind."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            alive = watch_local_trainers(procs, nranks)
            if not alive:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f'{len(alive)} of {nranks} trainers still running '
                    f'after {timeout} s; local trainers terminated')
            time.sleep(poll)
    finally:
        terminate_local_procs(procs)
