"""Host milliseconds of the trainer's exact OT pairing a step, the mean of
``FlowMatchingTrainer.stats["pair_seconds"]`` over the window's steps."""


def read(run):
    s = run.facts.get("ot_pair_s")
    return None if s is None else 1e3 * s
