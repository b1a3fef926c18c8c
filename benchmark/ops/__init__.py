"""Operations, one file each: ``Op(ctx)`` with set-up, window and check."""
