"""The paper's own configuration (Table III) — read-mapping parameters."""
from ..core.pipeline import MapperConfig

MAPPER = MapperConfig(read_len=150, k=12, w=30, eth=6, sat_affine=32,
                      max_minis=16, max_pls=32, filter_threshold=6)

# DART-PIM system parameters (Tables II/III)
MAX_READS = {"12.5k": 12_500, "25k": 25_000, "50k": 50_000}
LOW_TH = 3
READS_FIFO_ROWS = 160
LINEAR_BUF_ROWS = 32
AFFINE_BUF_ROWS = 64
