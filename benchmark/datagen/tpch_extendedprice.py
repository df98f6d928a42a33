"""Quantity times the part's retail price, in cents (TPC-H 4.2.3:
L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE; P_RETAILPRICE =
(90000 + ((P_PARTKEY / 10) modulo 20001) + 100 * (P_PARTKEY modulo 1000)) / 100).
SSB's dbgen prices lo_extendedprice the same way."""


def generate(table, args):
    pk = table.columns[args["partkey"]]
    cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    return table.columns[args["quantity"]] * cents
