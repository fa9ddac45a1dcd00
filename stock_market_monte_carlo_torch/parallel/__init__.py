from stock_market_monte_carlo_torch.parallel.mesh import (
    PathsMesh,
    device_count,
    paths_mesh,
)

__all__ = ["PathsMesh", "paths_mesh", "device_count"]
