"""The paper's figures whose data the port measures on the card: the
counterparts of ``benchmarks/fig2_strided.py``, ``fig3_tail.py``,
``fig4_arith.py`` to ``fig8_pressure.py``, ``fig9_qsim.py`` and
``table1_counters.py``.  Each module has ``run(...) -> list[dict]`` and a
``__main__`` that prints its table; none writes a result file.
"""
