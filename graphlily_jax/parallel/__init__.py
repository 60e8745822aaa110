from .mesh import make_mesh
from .dist_spmv import DistSpMV, ShardedSpMVLayout, pack_sharded
from .dist_apps import (dist_bfs_pull, dist_sssp_pull, dist_bfs_pull_push,
                        dist_sssp_pull_push)
