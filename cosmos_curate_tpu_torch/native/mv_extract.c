/* Codec motion-vector extraction over libavcodec (export_mvs).
 *
 * Equivalent capability of the reference's motion-vector backend
 * (cosmos_curate/pipelines/video/filtering/motion/motion_vector_backend.py
 * — PyAV/ffmpeg `export_mvs` side data feeding global-mean and
 * per-patch-min motion scores): the decoder exports per-block motion
 * vectors for inter-coded frames (mpeg4 AND h264 — whatever the clip was
 * transcoded with), and this binding aggregates them into a per-frame
 * grid of mean |mv| in pixels. Python (video/motion_vectors.py) turns the
 * grid into filter scores; frames without side data (intra frames) are
 * flagged so callers can exclude them.
 *
 * API (ctypes, cosmos_curate_tpu/native/__init__.py load_mv):
 *   curate_mv_field(path, grid, out_field, out_has, max_frames,
 *                   out_w, out_h) -> n_frames (<0 on error)
 *     out_field: float32 [max_frames][grid][grid] mean |mv| per cell
 *     out_has:   uint8   [max_frames] 1 when the frame carried MVs
 */

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/motion_vector.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

struct cell_acc {
    double sum;  /* |mv| weighted by overlap area */
    double area; /* total overlap area */
};

static void frame_cells(const AVFrame *frame, int grid, int w, int h,
                        float *out_cells, unsigned char *out_has) {
    AVFrameSideData *sd =
        av_frame_get_side_data(frame, AV_FRAME_DATA_MOTION_VECTORS);
    memset(out_cells, 0, (size_t)grid * grid * sizeof(float));
    *out_has = 0;
    if (!sd || w <= 0 || h <= 0)
        return;
    *out_has = 1;
    struct cell_acc *acc = calloc((size_t)grid * grid, sizeof(*acc));
    if (!acc)
        return;
    const AVMotionVector *mvs = (const AVMotionVector *)sd->data;
    size_t n = sd->size / sizeof(*mvs);
    for (size_t i = 0; i < n; i++) {
        const AVMotionVector *mv = &mvs[i];
        double scale = mv->motion_scale > 0 ? (double)mv->motion_scale : 1.0;
        double mag = hypot(mv->motion_x / scale, mv->motion_y / scale);
        /* area-weighted spread over every cell the BLOCK overlaps:
         * (dst_x, dst_y) is the block center and blocks (16x16 MBs) can be
         * coarser than the cell grid — center-point binning would leave
         * whole cell rows without vectors and fake a static patch */
        double x0 = mv->dst_x - mv->w / 2.0, x1 = x0 + mv->w;
        double y0 = mv->dst_y - mv->h / 2.0, y1 = y0 + mv->h;
        double cw = (double)w / grid, ch = (double)h / grid;
        int cx0 = (int)(x0 / cw), cx1 = (int)((x1 - 1e-9) / cw);
        int cy0 = (int)(y0 / ch), cy1 = (int)((y1 - 1e-9) / ch);
        if (cx0 < 0) cx0 = 0;
        if (cy0 < 0) cy0 = 0;
        if (cx1 >= grid) cx1 = grid - 1;
        if (cy1 >= grid) cy1 = grid - 1;
        for (int cy = cy0; cy <= cy1; cy++) {
            for (int cx = cx0; cx <= cx1; cx++) {
                double ox = fmin(x1, (cx + 1) * cw) - fmax(x0, cx * cw);
                double oy = fmin(y1, (cy + 1) * ch) - fmax(y0, cy * ch);
                if (ox <= 0 || oy <= 0)
                    continue;
                acc[cy * grid + cx].sum += mag * ox * oy;
                acc[cy * grid + cx].area += ox * oy;
            }
        }
    }
    for (int c = 0; c < grid * grid; c++)
        /* cells with no covering vectors stay 0: codecs skip static
         * blocks, which IS the "no motion" signal the filter keys on */
        out_cells[c] =
            acc[c].area > 0 ? (float)(acc[c].sum / acc[c].area) : 0.0f;
    free(acc);
}

int curate_mv_field(const char *path, int grid, float *out_field,
                    unsigned char *out_has, int max_frames, int *out_w,
                    int *out_h) {
    AVFormatContext *fmt = NULL;
    AVCodecContext *ctx = NULL;
    AVPacket *pkt = NULL;
    AVFrame *frame = NULL;
    AVDictionary *opts = NULL;
    int nframes = 0, ret = -1;

    av_log_set_level(AV_LOG_ERROR);
    if (grid <= 0 || max_frames <= 0)
        return -1;
    if (avformat_open_input(&fmt, path, NULL, NULL) < 0)
        return -1;
    if (avformat_find_stream_info(fmt, NULL) < 0)
        goto done;
    const AVCodec *dec = NULL;
    int vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (vstream < 0 || !dec)
        goto done;
    ctx = avcodec_alloc_context3(dec);
    if (!ctx || avcodec_parameters_to_context(
                    ctx, fmt->streams[vstream]->codecpar) < 0)
        goto done;
    av_dict_set(&opts, "flags2", "+export_mvs", 0);
    if (avcodec_open2(ctx, dec, &opts) < 0)
        goto done;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame)
        goto done;

    while (nframes < max_frames && av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == vstream &&
            avcodec_send_packet(ctx, pkt) >= 0) {
            while (nframes < max_frames &&
                   avcodec_receive_frame(ctx, frame) >= 0) {
                frame_cells(frame, grid, ctx->width, ctx->height,
                            out_field + (size_t)nframes * grid * grid,
                            out_has + nframes);
                nframes++;
            }
        }
        av_packet_unref(pkt);
    }
    /* drain the decoder */
    if (nframes < max_frames && avcodec_send_packet(ctx, NULL) >= 0) {
        while (nframes < max_frames &&
               avcodec_receive_frame(ctx, frame) >= 0) {
            frame_cells(frame, grid, ctx->width, ctx->height,
                        out_field + (size_t)nframes * grid * grid,
                        out_has + nframes);
            nframes++;
        }
    }
    if (out_w) *out_w = ctx->width;
    if (out_h) *out_h = ctx->height;
    ret = nframes;

done:
    av_dict_free(&opts);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
    return ret;
}
