"""Programs a captured loop reaches only by virtual dispatch
(``program.message(...)`` on an untyped receiver): parse-only."""
import numpy as np


class Program:
    def message(self, state, step):
        raise NotImplementedError


class Doubling(Program):
    def message(self, state, step):
        return state * 2.0


class Padded(Program):
    def message(self, state, step):
        pad = np.zeros(4)  # expect: JG102
        return state + float(step) + pad.sum()  # expect: JG101
