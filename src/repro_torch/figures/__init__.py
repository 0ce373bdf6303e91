"""The paper's figures whose data the port measures on the card: the
counterparts of ``benchmarks/fig2_strided.py``, ``fig3_tail.py`` and
``fig9_qsim.py``.  Each module has ``run(...) -> list[dict]`` and a
``__main__`` that prints its table; none writes a result file.
"""
