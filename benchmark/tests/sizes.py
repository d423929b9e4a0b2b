"""Small sizes of the two cells, for CPU tests: the cells' own
configuration and traffic with fewer lanes, points and rays."""

from benchmark.registry import Registry


def small(reg: Registry, workload: str) -> dict:
    """Overrides of ``run.run_cell`` that shrink ``workload``."""
    cell = reg.workload(workload)
    icp = dict(reg.config(cell['config'])['icp'])
    if cell['config'] == 'fleet256-hdl64-4k':
        return {'config': {'lanes': 4, 'points_per_scan': 1024,
                           'azimuths': 64,
                           'icp': dict(icp, reading_capacity=1024)},
                'traffic': {}}
    return {'config': {'map_points': 4096, 'map_azimuths': 128,
                       'reading_azimuths': 32,
                       'icp': dict(icp, reading_capacity=512)},
            'traffic': {'pool_readings': 8, 'batch': 4}}
