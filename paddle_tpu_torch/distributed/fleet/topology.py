"""Logical process topology (counterpart of
``paddle_tpu/distributed/fleet/topology.py``): ``CommunicateTopology``,
a named N-D grid over ranks answering rank <-> coordinate queries and
enumerating communication groups.  Pure arithmetic on names and sizes,
so it also describes topologies no process group runs yet.
"""
import itertools
import math

__all__ = ['CommunicateTopology']


class CommunicateTopology:
    def __init__(self, hybrid_group_names=('data', 'pipe', 'sharding',
                                           'model'),
                 dims=(1, 1, 1, 1)):
        if len(hybrid_group_names) != len(dims):
            raise ValueError('names and dims must align')
        self._names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world = int(math.prod(self._dims))
        coords = list(itertools.product(*[range(d) for d in self._dims]))
        self._coord_of_rank = {r: c for r, c in enumerate(coords)}
        self._rank_of_coord = {c: r for r, c in enumerate(coords)}

    @classmethod
    def from_mesh(cls, mesh):
        """Describe a mesh: any object with ``axis_names`` and a
        ``devices`` array (axis order kept)."""
        return cls(tuple(mesh.axis_names), tuple(mesh.devices.shape))

    def get_hybrid_group_names(self):
        return list(self._names)

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **coords):
        if sorted(coords) != sorted(self._names):
            raise ValueError(f'need every axis of {self._names}, '
                             f'got {sorted(coords)}')
        return self._rank_of_coord[tuple(coords[n] for n in self._names)]

    def get_coord(self, rank):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate along ``axis_name`` is ``index``."""
        ax = self._names.index(axis_name)
        return [r for r, c in self._coord_of_rank.items() if c[ax] == index]

    def get_comm_list(self, axis_name):
        """The groups of ranks that talk along ``axis_name``: one list
        for each combination of the other axes' coordinates."""
        ax = self._names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != ax]
        out = []
        for combo in itertools.product(*others):
            group = []
            for v in range(self._dims[ax]):
                c = list(combo)
                c.insert(ax, v)
                group.append(self._rank_of_coord[tuple(c)])
            out.append(group)
        return out
