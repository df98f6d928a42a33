"""An order's date, uniform over the days [first, last], on each of the
order's lines (TPC-H 4.2.3: O_ORDERDATE between STARTDATE and ENDDATE - 151
days). Days since 1970-01-01."""

from .. import dates


def generate(table, args):
    per_order = table.randint(dates.day(args["first"]), dates.day(args["last"]), table.orders())
    return table.per_order(per_order)
