"""Engine kinds, one module each, found by the name a configuration's
``"engine"`` gives. Each has ``build(config, device, seed)`` -> the system
under test, ``check(outputs)`` -> ({name: number}, work), the comparison
with the plain reference, and ``control()`` -> the context a control run
(``run.py --control 1``) runs in."""
