"""K2, the tree walk (csrc/treewalk.cu: tree_walk_kernel).  Per tree-force
evaluation: nb target blocks of G rows, a tree of `nodes` nodes, the
kernel's own counts of node visits and of monopoles applied, and the
leaf-list capacity LL it writes."""

from .peaks import bound_s

KERNELS = ("tree_walk_kernel",)
# per visit: wrap and |d| 12, dmin 10, r2min 5, criteria 11, inside 7
WALK_DECISION_OPS = 44
MONOPOLE_OPS = {False: 64, True: 70}  # the walk keeps r = 0 in the pot
WALK_ROW_BYTES = 36      # per node: two float4 rows and one int


def launch_bound_s(nb, G, LL, nodes, visits, monopoles, with_potential):
    ops = (visits * WALK_DECISION_OPS
           + monopoles * G * MONOPOLE_OPS[bool(with_potential)])
    # each node row read once (at most the visits); targets, block boxes,
    # aold, active read; acc, pot, leaf lists, leaf counts, flags, visit
    # and monopole counts written
    nbytes = (min(nodes, visits) * WALK_ROW_BYTES + nb * G * 12 + nb * 29
              + nb * G * 16 + nb * LL * 8 + nb * 17)
    return bound_s(ops, nbytes)


def bound_total_s(series, G, LL):
    return sum(launch_bound_s(nb, G, LL, c, v, m, wp) for nb, c, v, m, wp
               in zip(series["active_blocks"], series["walk_nodes"],
                      series["walk_visits_sum"], series["walk_monopoles"],
                      series["with_potential"]))
