"""map: the paper's mean average precision at k of every query answered
(both stretches of the run), against the plain reference's exact k-NN
(``reference/knn.py``)."""


def read(rec):
    return rec.accuracy["map"]
