"""A date a uniform [low, high] days after another date column of the same
row (TPC-H 4.2.3: L_SHIPDATE = O_ORDERDATE + random[1 .. 121])."""


def generate(table, args):
    return table.columns[args["of"]] + table.randint(int(args["low"]), int(args["high"]), table.n)
