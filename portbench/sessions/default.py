"""The receiver of a configuration that names no `session`: `Session` at
the configuration's `batch_blocks` for one channel, one `MultiSession`
(with `cond_mode`) for several, every channel at the one receiver mode and
its state stacked in rows [C, ...]. The timed receiver reports to the
harness's recorder."""


def make(ctx, sources, timed: bool):
    from tempestsdr_tpu_torch.stream.multisession import MultiSession
    from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks

    if ctx.pc is None:
        raise ValueError("the default session runs one receiver mode on every channel; a "
                         "configuration of mixed modes names a `session` of its own")
    cfg, rec = ctx.cfg, ctx.recorder
    on_frame = rec.frame if timed else None
    on_plot = rec.plot if timed else None
    if ctx.n_ch == 1:
        return Session(ctx.pc, ctx.params, sources[0], SessionCallbacks(
            on_frame=None if on_frame is None else (lambda f: on_frame(0, f)),
            on_plot=None if on_plot is None else (lambda ev: on_plot(0, ev))),
            batch_blocks=cfg["batch_blocks"], device=ctx.device)
    return MultiSession(ctx.pc, ctx.params, sources, on_frame=on_frame, on_plot=on_plot,
                        cond_mode=cfg["cond_mode"], device=ctx.device)


def channel_leaves(session, c: int) -> list:
    """Channel c's state leaves: the session's own, or row c of the stacked
    MultiSession's."""
    from tempestsdr_tpu_torch.stream.multisession import MultiSession
    from tempestsdr_tpu_torch.stream.state import state_leaves

    leaves = state_leaves(session.state)
    return [x[c] for x in leaves] if isinstance(session, MultiSession) else leaves
