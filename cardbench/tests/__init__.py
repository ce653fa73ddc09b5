"""The benchmark's own tests, on the CPU at small sizes (those that need
the card are marked ``cuda`` and skip without one):

    python -m pytest cardbench/tests
"""
