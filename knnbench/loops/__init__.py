"""The loops a traffic mix drives, one module each, found by the mix's
``"loop"`` name (``loops/<loop>.py``). A new kind of traffic, such as a
flush a tick, is a new module here; a new mix on an existing loop is a data
file in ``traffic/``.

Each module defines ``Loop(cell, bn, n, seed, dev)``, built in set-up from
the cell's configuration and mix (``bn`` None: the traffic alone, for the
control), with:

- ``sample_size``: how many of the window's operations the check judges;
- ``op(i) -> (pool, out, items)``: the window's i-th operation, enqueued
  (the harness synchronizes after it): the index of its input in the pool,
  its output, and the requests it answered;
- ``warm(dev)``: every shape the window uses, once;
- ``least_s(n, pools) -> {pool: seconds}``: the least time of one
  operation's work on the card (``yardstick``), for the rooflines;
- ``judge(bell, dij, sample, rng) -> {name: count}``: the check's numbers
  over the sampled ``(pool, out)``, each with limit 0;
- ``control(bell, dij, rng, bits) -> (numbers, fixed)``: the same numbers
  for the reference held at ``bits`` significant bits in the program's
  place, and the exact tables ``[(objects, ids, d)]`` it computed.
"""
