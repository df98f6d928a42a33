"""A value a row, uniform over [low, high] (TPC-H's random value within a
range, dbgen's RANDOM)."""


def generate(table, args):
    return table.randint(int(args["low"]), int(args["high"]), table.n)
