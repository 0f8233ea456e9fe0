from ray_tpu_torch._private.staticcheck import main

raise SystemExit(main())
