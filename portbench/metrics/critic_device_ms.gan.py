"""Device milliseconds of both critics' loops in one superstep: the work
launched inside the program's ranges ``superstep.critic_y2`` and
``superstep.critic_dem`` (``train/gan_trainer.py``; the critics through
``ops/fast_critic.py``), over the traced supersteps. Moves
``train_slices_per_s``."""


def read(ctx):
    supersteps = getattr(ctx, "supersteps", None)
    if not supersteps:
        return None
    seconds = ctx.trace.seconds_under(("superstep.critic_y2", "superstep.critic_dem"))
    return 1e3 * seconds / len(supersteps) if seconds > 0 else None
