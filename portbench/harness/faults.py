"""Faults planted under a run, to show that ``correct`` catches them.

Each fault breaks the timed path underneath the driver, in what its set-up
returns, and leaves the benchmark and the reference alone:

- ``unchanged``: a train step returns its state unchanged (the optimizer
  takes no step); a served request returns the previous request's answer;
- ``half_batch``: a train step sees the first half of each batch, its mean
  taken over those rows; a request answers the second half of its
  sentences with zeros;
- ``altered``: an answer altered where it is produced: the first
  sentence's model output reflected (1 - x), every frame.

One card holds every cell, so no cell has an exchange between cards to
leave out.
"""

import contextlib

import torch


def _reflect_first_sentence(out: torch.Tensor) -> torch.Tensor:
    return torch.cat([1.0 - out[:1], out[1:]])


def _train(s, name):
    if name == "unchanged":
        s.state.optimizer.step = lambda *args, **kwargs: None
    elif name == "half_batch":
        step = s.step
        s.step = lambda st, batch, gen: step(
            st, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, gen)
    elif name == "altered":
        forward = s.model.forward
        s.model.forward = lambda *args, **kwargs: _reflect_first_sentence(forward(*args, **kwargs))
    else:
        raise KeyError(name)


def _synthesis(s, name):
    request = s.request
    if name == "unchanged":
        last = {}

        def stale(tokens, lengths):
            answer = request(tokens, lengths)
            stale_answer = last.get("answer", answer)
            last["answer"] = answer
            return stale_answer
        s.request = stale
    elif name == "half_batch":
        def half(tokens, lengths):
            answer = request(tokens, lengths)
            return {k: torch.cat([v[: len(lengths) // 2], torch.zeros_like(v[len(lengths) // 2:])])
                    for k, v in answer.items()}
        s.request = half
    elif name == "altered":
        def altered(tokens, lengths):
            answer = request(tokens, lengths)
            return {**answer, "contours": _reflect_first_sentence(answer["contours"])}
        s.request = altered
    else:
        raise KeyError(name)


PLANT = {"train": _train, "synthesis": _synthesis}
NAMES = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(driver, kind: str, name: str):
    """Within the block, ``driver.setup`` returns a set-up with fault
    ``name`` planted."""
    setup = driver.setup

    def broken(*args, **kwargs):
        s = setup(*args, **kwargs)
        PLANT[kind](s, name)
        return s

    driver.setup = broken
    try:
        yield
    finally:
        driver.setup = setup
