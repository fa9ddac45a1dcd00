"""The counter stream's sliced-rotation bootstrap, per path-month: the
path's word, its destination index and the tail test, the row rotation
where the index leaves the tail, the source lane's word times n and its
index, the source chunk's select, the table address and load (13); per
tile-month the month key's word. Bytes: the table, read once."""

from smmc_bench.work import IDX, WORD, path_months, tile_months


def work(config, traffic):
    n = config["model"]["table_rows"]
    tail_n = n - 128 * (-(-n // 128) - 1)
    per = WORD + IDX + 1 + 3 * (1.0 - tail_n / n) + 13
    return dict(bytes=4.0 * n,
                scalar_ops=path_months(config) * per
                + tile_months(config) * WORD,
                tensor_flop=0.0)
