import sys

from stock_market_monte_carlo_torch.cli.main import main

sys.exit(main() or 0)
