"""Operations and bytes of the port's kernels, counted from their call
shapes, and the H100's published peaks."""
